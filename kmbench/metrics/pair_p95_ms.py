"""The 95th percentile over all of the window's requests of the time from a
request's issue to its last warped volume complete on the card (CUDA
events)."""

from kmbench.readings import quantile


def read(data):
    return quantile(data.get("latencies_ms") or [], 0.95)
