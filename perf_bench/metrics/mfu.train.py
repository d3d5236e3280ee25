"""``mfu.train``: FLOPs of one train step (forward and backward, counted on
the plain reference model at a card's batch), times the steps and cards,
over the window, over the cards' bf16 peak."""

from perf_bench import counts


def read(job, outcome):
    L = outcome.layer
    if not L["steps"]:
        return None
    flops = counts.train_flops_per_step(L["model"], L["image_size"], L["batch_size"])
    return (100.0 * flops * L["steps"] * L["chips"] / L["window_s"]
            / (counts.PEAK_BF16_FLOPS * L["chips"]))
