"""``device_idle.serve``: per cent of the traced serving window with no
kernel, copy or fill on the card."""

from perf_bench.metrics._common import device_idle


def read(job, outcome):
    return device_idle(outcome)
