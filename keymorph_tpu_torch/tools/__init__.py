"""Utilities of the port."""


def card(device="cuda"):
    """The card as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` reports it (its first line), for the record
    every device tool prints beside its numbers; None where ``device`` is
    not a CUDA device (a CPU run names no card)."""
    import subprocess

    import torch

    if torch.device(device).type != "cuda":
        return None
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def mean_ms(fn, inputs, device):
    """(mean ms of ``fn(*args)`` over ``inputs`` after a warm-up call on the
    first, the timer's name): CUDA events around each call on the card, the
    host clock on the CPU (where no device time exists)."""
    import time

    import torch

    fn(*inputs[0])
    if torch.device(device).type != "cuda":
        times = []
        for args in inputs:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
        return sum(times) / len(times), "host_clock"
    events = []
    for args in inputs:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / len(events), "cuda_events"
