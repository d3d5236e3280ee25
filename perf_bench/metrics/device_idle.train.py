"""``device_idle.train``: per cent of the traced training window with no
kernel, copy or fill on the card (rank 0)."""

from perf_bench.metrics._common import device_idle


def read(job, outcome):
    return device_idle(outcome)
