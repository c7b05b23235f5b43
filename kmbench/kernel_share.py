"""A hand-written kernel's share of its roofline, read from the profile by
the kernel's name (as ``readings.conv_roofline_pct`` reads the 3x3x3
convs'): the sum of the plan's per-call bounds over the profiled units, over
the summed device time of the kernels of that name. None unless the profile
holds exactly the calls the plan predicts, or where the run's record has no
plan for the kernel."""

from __future__ import annotations

from kmbench.readings import profiled


def roofline_pct(data, kernel, calls_key: str, bound_key: str):
    """``kernel``: a compiled pattern searched in each device kernel's name;
    ``data[calls_key]`` the kernel's calls a unit, ``data[bound_key]`` the
    seconds their bounds sum to a unit."""
    if calls_key not in data or bound_key not in data:
        return None
    reading, n = profiled(data)
    if reading is None:
        return None
    ks = [d for d in reading.kernels() if kernel.search(d[0])]
    if not ks or len(ks) != n * data[calls_key]:
        return None
    busy_s = sum(e - s for _, s, e, _, _ in ks) / 1e6
    return 100.0 * n * data[bound_key] / busy_s
