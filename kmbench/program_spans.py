"""The program's own spans, read from a traced run's profile.

keymorph_tpu_torch opens a ``torch.profiler`` range named ``km.<span>``
around its layers while the profiler records (``keymorph_tpu_torch/
tracing.py``), so the ranges share the profile's clock with the device's
operations. The readings here work over the ``trace.Reading`` a traced run
hands its readers as ``data["profile"]``:

  * a device operation belongs to the innermost ``km.*`` range open on the
    thread that launched it; where that thread has none open (autograd's
    device thread running a backward node that opens no span), to the
    innermost ``km.*`` range open on any thread at the launch;
  * it falls inside span S when that range is an S range or lies within
    one, on any thread (the conv backward's ranges on autograd's thread lie
    within ``km.train.backward`` on the main one);
  * its idle gap is the device's idle time between the end of every
    operation before it and its start.

A reading is None where the profile holds no range of the span (a program
that opens none, or a run that never entered it), never 0 for that.
"""

from __future__ import annotations

from kmbench.readings import profiled

PREFIX = "km."


def _attribution(reading):
    """(names of the profile's ``km.*`` ranges, [(device op, names of the
    spans it falls inside)])."""
    ranges = sorted(((s, e, name, tid) for tid, rs in reading.host.items()
                     for s, e, name in rs if name.startswith(PREFIX)),
                    key=lambda r: (r[0], -r[1]))
    # the names of the ranges each range lies within, its own included;
    # ranges sorted by (start, -end) put every container before what it holds
    around = [frozenset(o[2] for o in ranges[: i + 1] if o[1] >= r[1])
              for i, r in enumerate(ranges)]
    launches = sorted((ts, corr, tid) for corr, (tid, ts) in reading.launches.items())
    owner, active, nxt = {}, [], 0
    for ts, corr, tid in launches:
        while nxt < len(ranges) and ranges[nxt][0] <= ts:
            active.append(nxt)
            nxt += 1
        active = [i for i in active if ranges[i][1] >= ts]
        mine = [i for i in active if ranges[i][3] == tid]
        if mine or active:
            owner[corr] = max(mine or active)  # the innermost: the latest in sort order
    ops = [(d, around[owner[d[4]]] if d[4] in owner else frozenset()) for d in reading.device]
    return {r[2] for r in ranges}, ops


def device_ms(reading, span: str):
    """Summed device time (ms) of the operations inside ``km.<span>``."""
    name = PREFIX + span
    names, ops = _attribution(reading)
    if name not in names:
        return None
    return sum(d[2] - d[1] for d, inside in ops if name in inside) / 1e3


def idle_ms(reading, span: str):
    """Summed idle gaps (ms) of the device before the operations inside
    ``km.<span>``."""
    name = PREFIX + span
    names, ops = _attribution(reading)
    if name not in names:
        return None
    idle, end = 0.0, None
    for d, inside in ops:  # by start
        if end is not None and d[1] > end and name in inside:
            idle += d[1] - end
        end = d[2] if end is None else max(end, d[2])
    return idle / 1e3


def per_unit(data, reading_fn, span: str, per: int = 1):
    """``reading_fn(profile, span)`` over the profiled units, each unit
    ``per`` of what is counted (2 volumes a serving request); None where
    nothing was profiled, the device recorded nothing or no range of the
    span was opened."""
    reading, n = profiled(data)
    if reading is None:
        return None
    value = reading_fn(reading, span)
    return None if value is None else value / (n * per)
