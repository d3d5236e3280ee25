"""Associative-Embedding-style stacked hourglass (the second model family),
in PyTorch.

Port of ``improved_body_parts_tpu/models/ae_pose.py`` (:26-90; reference
models/ae_pose.py:21-77, models/ae_layer.py): a plain conv stem, N
single-output hourglasses of residuals, two BN-free 3x3 refinement convs
and a 1x1 head a stack, and full-scale merges between stacks. It
supervises only the full-resolution scale: ``forward`` returns
``[nstack][1]`` maps, so the multi-task loss applies with its leading
scale weight. Children carry the Flax names (``utils/checkpoint.py``
``flax_to_variant_key`` maps them); BatchNorm mode and precision follow
``models/imhn.py``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from improved_body_parts_tpu_torch.configs import ModelConfig
from improved_body_parts_tpu_torch.models.imhn import (
    BNStats, Conv, Residual, _PoseNetBase, max_pool2, upsample_nearest2,
)


class AEHourglass(nn.Module):
    """Classic single-output recursive hourglass (reference ae_layer.py);
    children ``d<d>_{up1,low1,low2,inner}``."""

    def __init__(self, depth: int, nfeat: int, increase: int, device=None):
        super().__init__()
        self.depth = depth
        for d in range(depth):
            c = nfeat + increase * d
            cn = c + increase
            self.add_module(f"d{d}_up1", Residual(c, c, device=device))
            self.add_module(f"d{d}_low1", Residual(c, cn, device=device))
            if d == depth - 1:
                self.add_module(f"d{d}_inner", Residual(cn, cn, device=device))
            self.add_module(f"d{d}_low2", Residual(cn, c, device=device))

    def _level(self, d: int, x, bn_stats: BNStats):
        mod = lambda name: getattr(self, f"d{d}_{name}")
        up1 = mod("up1")(x, bn_stats)
        low = mod("low1")(max_pool2(x), bn_stats)
        low2 = (mod("inner")(low, bn_stats) if d == self.depth - 1
                else self._level(d + 1, low, bn_stats))
        return up1 + upsample_nearest2(mod("low2")(low2, bn_stats))

    def forward(self, x, bn_stats: BNStats = None):
        return self._level(0, x, bn_stats)


class AEPoseNet(_PoseNetBase):
    """Stacked AE hourglass. Input NHWC images in [0, 1]; ``forward``
    returns ``[nstack][1]`` NHWC fp32 maps at stride 4 (reference
    ae_pose.py:46-57). Arguments as ``models.imhn.PoseNet``'s."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), *, device=None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.quant = None
        self.compute_dtype = compute_dtype
        inp, oup = cfg.inp_dim, cfg.oup_dim
        head = dict(bn=False, relu=False, device=device)
        self.pre0 = Conv(3, 64, 7, stride=2, device=device)
        self.pre1 = Conv(64, 128, 3, device=device)
        self.pre2 = Conv(128, 128, 3, device=device)
        self.pre3 = Conv(128, inp, 3, device=device)
        for t in range(cfg.nstack):
            self.add_module(f"hg{t}", AEHourglass(cfg.depth, inp, cfg.increase,
                                                  device=device))
            self.add_module(f"refine{t}_0", Conv(inp, inp, 3, bn=False, device=device))
            self.add_module(f"refine{t}_1", Conv(inp, inp, 3, bn=False, device=device))
            self.add_module(f"out{t}", Conv(inp, oup, 1, **head))
            if t < cfg.nstack - 1:
                self.add_module(f"merge_pred{t}", Conv(oup, inp, 1, **head))
                self.add_module(f"merge_feat{t}", Conv(inp, inp, 1, **head))
        self._init(device, generator)

    def _run(self, imgs: torch.Tensor, full: bool,
             bn_stats: BNStats = None) -> List[List[torch.Tensor]]:
        cfg = self.cfg
        x = imgs.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = self.pre1(self.pre0(x, bn_stats), bn_stats)
        x = self.pre3(self.pre2(max_pool2(x), bn_stats), bn_stats)
        preds: List[List[torch.Tensor]] = []
        for t in range(cfg.nstack):
            f = getattr(self, f"hg{t}")(x, bn_stats)
            f = getattr(self, f"refine{t}_0")(f, bn_stats)
            f = getattr(self, f"refine{t}_1")(f, bn_stats)
            pred = getattr(self, f"out{t}")(f, bn_stats)
            preds.append([pred])
            if t < cfg.nstack - 1:
                x = (x + getattr(self, f"merge_pred{t}")(pred, bn_stats)
                     + getattr(self, f"merge_feat{t}")(f, bn_stats))
        return self._outputs(preds)
