"""Run one cell of the benchmark once.

    python3 -m kmbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``kmbench/`` and
the program under test, ``keymorph_tpu_torch/``. The run draws its weights
and volumes from the seed on the card, builds or loads the program's
kernels (``build/keymorph_tpu_torch/<hash>/`` in the checkout), warms up
the cell's shapes, measures for ``--seconds``, frees the program's state,
checks the window's answers against the plain reference, and prints:

  * on standard error, last, one line per number compared, with its limit;
  * on standard output, last, one JSON object: ``correct``, ``attempted``,
    ``failed``, ``metrics`` (the cell's end-to-end metrics with
    ``--trace 0``, its per-layer ones with ``--trace 1``), ``device``
    (``busy_s`` and ``window_s`` of the profiled stretch with ``--trace 1``),
    with ``--trace 1`` a ``breakdown``, and last ``check``: each number
    compared, with its limit.

It exits non-zero and prints no result without a CUDA device (or with fewer
than the cell asks for), on any failure, and when JAX, jaxlib, flax or
keymorph_tpu was loaded into the process.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

from kmbench.registry import ROOT, Cell  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "keymorph_tpu")


class NoDevice(RuntimeError):
    pass


@dataclass
class Context:
    """What a driver is given: the cell's configuration and traffic, the
    run's seed, window length and tracing switch, the device, and the
    process's start on the host clock."""

    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float


def forbidden_modules():
    """The loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``keymorph_tpu_torch`` is not ``keymorph_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card_limit():
    """The card's power limit as ``nvidia-smi`` reports it, or None."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def execute(workload, seed, seconds, trace, *, device=None, root=ROOT, config=None,
            t_start=T_START):
    """Run the cell; return (result, check rows). ``device`` None is the
    card, whose absence raises :class:`NoDevice`; the harness's own tests
    pass ``"cpu"`` and a small ``config``."""
    import torch

    cell = Cell(workload, root)
    cfg = dict(cell.config, **(config or {}))
    chips = int(cell.entry["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoDevice(f"{workload} needs {chips} CUDA device(s); "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                           f"visible")
        device = "cuda"
    dev = torch.device(device)
    from keymorph_tpu_torch import disable_tf32

    disable_tf32()  # the configurations state float32 geometry with TF32 off
    ctx = Context(workload, cfg, cell.traffic, int(seed), float(seconds), bool(trace), dev,
                  t_start)
    driver = cell.driver()
    window = driver.run(ctx)
    on_card = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    data = dict(window.data, peak_bytes=peak)
    answers = window.answers
    window.release()
    del window
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    from kmbench import judge

    correct, rows = judge.verdict(driver.judge_window(ctx, answers), cell.limits)

    metrics = {}
    for m in (cell.per_layer() if trace else cell.end_to_end()):
        value = cell.reader(m["name"])(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": int(data["units"]), "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if on_card else None,
                         "count": chips, "memory_peak_bytes": peak,
                         "power_limit": card_limit() if on_card else None}}
    reading = data.get("profile")
    if trace and reading is not None:
        result["device"]["busy_s"] = reading.busy_us() / 1e6
        result["device"]["window_s"] = reading.wall_us / 1e6
        result["breakdown"] = {"device_ops": reading.top_device_ops(10),
                               "idle_gaps": reading.idle_gaps(10)}
    result["setup_parts_s"] = data["setup_parts_s"]
    result["check"] = {name: {"value": _finite(value), "limit": limit}
                       for name, value, limit in rows}
    return result, rows


def _finite(x):
    """A number for the JSON line; a non-finite gap (a broken answer) is
    null there and printed as it is on standard error."""
    return x if x == x and abs(x) != float("inf") else None


def cache_dirs(root=ROOT):
    """Point every build and kernel cache a program could use at fixed
    directories inside the checkout (``build/`` there), so that only a
    checkout's first run builds. The program's own kernel library already
    lands in ``build/keymorph_tpu_torch/<hash>/``."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    cache_dirs()
    try:
        result, rows = execute(args.workload, args.seed, args.seconds, args.trace)
    except NoDevice as e:
        print(f"kmbench: {e}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"kmbench: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    print("setup " + " ".join(f"{k} {v:.3f} s" for k, v in result["setup_parts_s"].items()),
          file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
