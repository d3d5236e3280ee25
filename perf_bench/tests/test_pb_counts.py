"""The benchmark's FLOP and byte arithmetic against counts made by hand
from each layer's shapes."""

import torch
from torch import nn

from perf_bench import counts
from perf_bench.reference.model import build
from perf_bench.tests._tiny import SIZE, TINY_MODEL


def hand_flops(model_cfg, size, batch, train):
    """2 x multiply-accumulates of every conv and linear the forward runs,
    read off each module's input and output shapes; a train step adds the
    backward's two products a layer (input gradient and weight gradient),
    less the input gradient of the first conv, whose input needs none."""
    model = build(model_cfg)
    macs, first = [], []

    def conv(m, inp, out):
        k = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
        macs.append(out.numel() * k)
        if not first:
            first.append(out.numel() * k)

    def lin(m, inp, out):
        macs.append(out.numel() * m.weight.shape[1])

    hooks = []
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, nn.Linear):
            hooks.append(m.register_forward_hook(lin))
    imgs = torch.zeros(batch, size, size, 3)

    # the reference calls F.conv2d on the modules' weights, not the modules:
    # run each conv module once on its input shape to record it
    def run_forward(full):
        from perf_bench.reference import model as rm

        class Hooked(rm.Ctx):
            def conv(self, c, x):
                return c(x)

            def linear(self, l, x):
                return l(x)
        if full:
            return model.run(imgs, Hooked({}), full=True)
        return model.run(imgs, Hooked(None), full=False)

    with torch.no_grad():
        run_forward(train)
    for h in hooks:
        h.remove()
    fwd = 2 * sum(macs)
    if not train:
        return fwd
    return 3 * fwd - 2 * first[0]


def test_serve_flops_match_a_hand_count():
    got = counts.serve_flops_per_frame(TINY_MODEL, SIZE)
    assert got == hand_flops(TINY_MODEL, SIZE, 2, train=False)


def test_train_flops_match_a_hand_count():
    got = counts.train_flops_per_step(TINY_MODEL, SIZE, 2)
    assert got == hand_flops(TINY_MODEL, SIZE, 2, train=True)


def test_nms_bytes():
    # 2 frames x 18 keypoint maps of 16 x 16 fp32 cells, read and written
    assert counts.nms_bytes(2, 64) == 2 * 18 * 16 * 16 * 4 * 2
    assert counts.nms_bytes(32, 512) == 32 * 18 * 128 * 128 * 8


def test_peaks_are_the_data_sheets():
    assert counts.PEAK_BF16_FLOPS == 989e12
    assert counts.PEAK_HBM_BYTES_PER_S == 3.35e12
