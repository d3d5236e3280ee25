"""``nms_roofline.serve``: the least time of one ``nms`` launch at the
batch's keypoint-map shape (bytes read and written once at the card's HBM
rate) over the ``nms`` kernel's mean device time in the trace."""

from perf_bench import counts

KERNEL = "nms_kernel"


def read(job, outcome):
    if not outcome.trace:
        return None
    hits = [v for name, v in outcome.trace["kernels"].items() if KERNEL in name]
    n = sum(c for c, _ in hits)
    if not n:
        return None
    mean_s = sum(s for _, s in hits) / n
    L = outcome.layer
    bound_s = counts.nms_bytes(L["batch_size"], L["frame_size"]) / counts.PEAK_HBM_BYTES_PER_S
    return 100.0 * bound_s / mean_s
