"""``mfu.serve``: FLOPs of one served frame (the frame and its mirror,
counted on the plain reference model), times the frames returned in the
window, over the window, over the card's bf16 peak."""

from perf_bench import counts


def read(job, outcome):
    L = outcome.layer
    if not L["frames_returned"]:
        return None
    flops = counts.serve_flops_per_frame(L["model"], L["frame_size"])
    return 100.0 * flops * L["frames_returned"] / L["window_s"] / counts.PEAK_BF16_FLOPS
