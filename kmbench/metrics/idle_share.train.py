"""1 - the union of device intervals over the host's wall time, over the
profiled steps."""

from kmbench.readings import idle_share_pct


def read(data):
    return idle_share_pct(data)
