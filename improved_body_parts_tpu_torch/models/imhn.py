"""IMHN (Identity-Mapping Hourglass Network) ``PoseNet`` in PyTorch.

Port of ``improved_body_parts_tpu/models/imhn.py`` (the live ``PoseNet``,
:51-328). Module and attribute names are the reference's
(models/posenet.py:50-144, models/layers_transposed.py:12-310), so
``load_state_dict(strict=True)`` takes a released reference ``.pth``, the
output of the JAX package's ``export_to_torch_state_dict`` and the test
mirror's ``TPoseNet`` state_dict alike.

Precision follows the JAX model: parameters are stored in fp32; convs and
linears run in ``compute_dtype`` (bf16 by default) on weights cast at the
call; BatchNorm math runs in fp32 (eps 1e-5) and is cast back; the SE mean is
taken in fp32; outputs are cast to fp32. Convs are
``torch.nn.functional.conv2d`` (cuDNN on the card), as the JAX package left
them to XLA. Public tensors are NHWC like the JAX model's; inside, tensors
are NCHW, and ``channels_last`` in memory when the input and the module are.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from improved_body_parts_tpu_torch.configs import ModelConfig

LEAKY_SLOPE = 0.01
BN_EPS = 1e-5
# reference init: conv kernels ~ N(0, 0.001), SE linears ~ N(0, 0.01)
# (models/posenet.py:124-144)
CONV_INIT_STD = 0.001
DENSE_INIT_STD = 0.01


def conv_bn(conv: nn.Conv2d, bn: Optional[nn.BatchNorm2d], x: torch.Tensor,
            relu: bool) -> torch.Tensor:
    """conv in ``x.dtype`` -> [BN in fp32, cast back] -> [LeakyReLU]."""
    dt = x.dtype
    bias = None if conv.bias is None else conv.bias.to(dt)
    y = F.conv2d(x, conv.weight.to(dt), bias, conv.stride, conv.padding,
                 conv.dilation)
    if bn is not None:
        mul = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
        y = ((y.float() - bn.running_mean[:, None, None]) * mul[:, None, None]
             + bn.bias[:, None, None]).to(dt)
    return F.leaky_relu(y, LEAKY_SLOPE) if relu else y


class Conv(nn.Module):
    """conv -> [BN] -> [LeakyReLU]; bias only when BN is off.
    reference: models/layers_transposed.py:90-157 (``Conv``/``DilatedConv``)."""

    def __init__(self, ins: int, outs: int, k: int = 3, stride: int = 1,
                 bn: bool = True, relu: bool = True, dilation: int = 1,
                 device=None):
        super().__init__()
        pad = dilation * (k - 1) // 2
        self.conv = nn.Conv2d(ins, outs, k, stride, pad, bias=not bn,
                              dilation=dilation, device=device)
        self.bn = nn.BatchNorm2d(outs, device=device) if bn else None
        self.relu = nn.LeakyReLU(LEAKY_SLOPE) if relu else None

    def forward(self, x):
        return conv_bn(self.conv, self.bn, x, self.relu is not None)


class Residual(nn.Module):
    """Bottleneck residual 1x1 -> 3x3 -> 1x1 with an identity (or 1x1) skip.
    reference: models/layers_transposed.py:12-48."""

    def __init__(self, ins: int, outs: int, device=None):
        super().__init__()
        mid = outs // 2
        self.convBlock = nn.Sequential(
            nn.Conv2d(ins, mid, 1, bias=False, device=device),
            nn.BatchNorm2d(mid, device=device), nn.LeakyReLU(LEAKY_SLOPE),
            nn.Conv2d(mid, mid, 3, 1, 1, bias=False, device=device),
            nn.BatchNorm2d(mid, device=device), nn.LeakyReLU(LEAKY_SLOPE),
            nn.Conv2d(mid, outs, 1, bias=False, device=device),
            nn.BatchNorm2d(outs, device=device))
        if ins != outs:
            self.skipConv = nn.Sequential(
                nn.Conv2d(ins, outs, 1, bias=False, device=device),
                nn.BatchNorm2d(outs, device=device))
        else:
            self.skipConv = None

    def forward(self, x):
        cb = self.convBlock
        h = conv_bn(cb[0], cb[1], x, True)
        h = conv_bn(cb[3], cb[4], h, True)
        h = conv_bn(cb[6], cb[7], h, False)
        if self.skipConv is not None:
            x = conv_bn(self.skipConv[0], self.skipConv[1], x, False)
        return F.leaky_relu(h + x, LEAKY_SLOPE)


class SELayer(nn.Module):
    """Squeeze-and-excitation. reference: layers_transposed.py:289-310."""

    def __init__(self, c: int, reduction: int = 16, device=None):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(c, c // reduction, device=device),
            nn.LeakyReLU(LEAKY_SLOPE),
            nn.Linear(c // reduction, c, device=device), nn.Sigmoid())

    def forward(self, x):
        dt = x.dtype
        fc1, fc2 = self.fc[0], self.fc[2]
        y = x.float().mean(dim=(2, 3)).to(dt)          # global pool in fp32
        y = F.leaky_relu(F.linear(y, fc1.weight.to(dt), fc1.bias.to(dt)),
                         LEAKY_SLOPE)
        y = torch.sigmoid(F.linear(y, fc2.weight.to(dt), fc2.bias.to(dt)))
        return x * y[:, :, None, None]


def max_pool2(x):
    return F.max_pool2d(x, 2, 2)


def upsample_nearest2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Backbone(nn.Module):
    """Dilated stem -> ``out_dim`` channels at stride 4.
    reference: layers_transposed.py:160-196."""

    def __init__(self, out_dim: int = 256, device=None):
        super().__init__()
        q, h = out_dim // 4, out_dim // 2
        self.conv1 = nn.Conv2d(3, q, 7, 2, 3, bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(q, device=device)
        self.res1 = Residual(q, h, device=device)
        self.res2 = Residual(h, h, device=device)
        self.dilation = nn.Sequential(*[
            Conv(h, h, 3, dilation=d, device=device)
            for d in (3, 3, 4, 4, 5, 5)])

    def forward(self, x):
        x = conv_bn(self.conv1, self.bn1, x, True)
        x = self.res2(max_pool2(self.res1(x)))
        return torch.cat([x, self.dilation(x)], dim=1)


class Hourglass(nn.Module):
    """Recursive hourglass returning ``depth + 1`` scales, finest first.
    reference: layers_transposed.py:199-286; per level ``hg[d]`` holds
    [up1, low1, low2, refine conv, (inner, deepest level only)]."""

    def __init__(self, depth: int, nfeat: int, increase: int, device=None):
        super().__init__()
        self.depth = depth
        levels = []
        for d in range(depth):
            c = nfeat + increase * d
            cn = c + increase
            mods = [Residual(c, c, device=device),
                    Residual(c, cn, device=device),
                    Residual(cn, c, device=device),
                    Conv(c, c, 3, device=device)]
            if d == depth - 1:
                mods.append(Residual(cn, cn, device=device))
            levels.append(nn.ModuleList(mods))
        self.hg = nn.ModuleList(levels)

    def _level(self, d: int, x, downs: List[torch.Tensor]):
        mods = self.hg[d]
        up1 = mods[0](x)
        low = mods[1](max_pool2(x))
        low2 = mods[4](low) if d == self.depth - 1 else self._level(d + 1, low, downs)
        downs.append(low2)                      # innermost appended first
        low3 = mods[2](low2)
        return up1 + mods[3](upsample_nearest2(low3))

    def forward(self, x):
        downs: List[torch.Tensor] = []
        top = self._level(0, x, downs)
        return [top] + downs[::-1]


class Features(nn.Module):
    """Per-scale regression trunks Conv3x3 -> Conv3x3 -> SE.
    reference: posenet.py:25-47."""

    def __init__(self, inp_dim: int, increase: int, num_scales: int,
                 reduction: int = 16, device=None):
        super().__init__()
        self.before_regress = nn.ModuleList([
            nn.Sequential(Conv(inp_dim + i * increase, inp_dim, 3, device=device),
                          Conv(inp_dim, inp_dim, 3, device=device),
                          SELayer(inp_dim, reduction, device=device))
            for i in range(num_scales)])


class Merge(nn.Module):
    """1x1 conv + BN cross-stack merge (reference ``Merge``)."""

    def __init__(self, x_dim: int, y_dim: int, device=None):
        super().__init__()
        self.conv = Conv(x_dim, y_dim, 1, relu=False, device=device)

    def forward(self, x):
        return self.conv(x)


class PoseNet(nn.Module):
    """Multi-stack IMHN. Input NHWC images in [0, 1]; ``forward`` returns
    ``[nstack][num_scales]`` NHWC fp32 maps with ``oup_dim`` channels.

    ``compute_dtype`` is the type convs and linears run in (bf16 for
    serving, fp32 for parity checks). Weights start from the reference init
    drawn from ``generator`` (which must live on ``device``), or stay
    uninitialised on the ``meta`` device."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), *, device=None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 quant: Optional[str] = None):
        super().__init__()
        if cfg.legacy_blocks or cfg.extra_attention or not cfg.cross_stack:
            raise NotImplementedError(
                "only the live PoseNet is ported (no legacy_blocks, "
                "extra_attention or cross_stack=False variants yet)")
        if quant is not None:
            raise NotImplementedError("int8 quantization is not ported yet")
        if cfg.num_scales != cfg.depth + 1:
            raise ValueError(f"num_scales {cfg.num_scales} != depth + 1")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        inp, inc, S = cfg.inp_dim, cfg.increase, cfg.num_scales
        self.pre = Backbone(inp, device=device)
        self.hourglass = nn.ModuleList()
        self.features = nn.ModuleList()
        self.outs = nn.ModuleList()
        self.merge_features = nn.ModuleList()
        self.merge_preds = nn.ModuleList()
        for t in range(cfg.nstack):
            self.hourglass.append(Hourglass(cfg.depth, inp, inc, device=device))
            self.features.append(Features(inp, inc, S, cfg.se_reduction,
                                          device=device))
            self.outs.append(nn.ModuleList([
                Conv(inp, cfg.oup_dim, 1, bn=False, relu=False, device=device)
                for _ in range(S)]))
            if t < cfg.nstack - 1:
                self.merge_features.append(nn.ModuleList([
                    Merge(inp, inp + j * inc, device=device) for j in range(S)]))
                self.merge_preds.append(nn.ModuleList([
                    Merge(cfg.oup_dim, inp + j * inc, device=device)
                    for j in range(S)]))
        if torch.device(device or "cpu").type != "meta":
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Reference init: conv N(0, 0.001), linear N(0, 0.01), zero biases,
        BatchNorm at identity (scale 1, shift 0, mean 0, var 1)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = CONV_INIT_STD if isinstance(m, nn.Conv2d) else DENSE_INIT_STD
                m.weight.normal_(0.0, std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def _run(self, imgs: torch.Tensor, full: bool) -> List[List[torch.Tensor]]:
        cfg = self.cfg
        x = self.pre(imgs.permute(0, 3, 1, 2).to(self.compute_dtype))
        preds: List[List[torch.Tensor]] = []
        caches: List[Optional[torch.Tensor]] = [None] * cfg.num_scales
        for t in range(cfg.nstack):
            last = t == cfg.nstack - 1
            hg = self.hourglass[t](x)
            if t > 0:
                hg = [h + c for h, c in zip(hg, caches)]
            # the last stack's coarser scales feed nothing when only the
            # final scale-0 map is read
            scales = range(cfg.num_scales) if (full or not last) else (0,)
            stack = []
            for s in scales:
                feat = self.features[t].before_regress[s](hg[s])
                pred = self.outs[t][s](feat)
                stack.append(pred)
                if not last:
                    cache = (self.merge_preds[t][s](pred)
                             + self.merge_features[t][s](feat))
                    if s == 0:
                        x = x + cache
                    caches[s] = cache
            preds.append(stack)
        return [[p.float().permute(0, 2, 3, 1) for p in st] for st in preds]

    def forward(self, imgs: torch.Tensor) -> List[List[torch.Tensor]]:
        """imgs (B, H, W, 3) in [0, 1] -> [nstack][num_scales] NHWC fp32."""
        return self._run(imgs, full=True)

    def predict_maps(self, imgs: torch.Tensor) -> torch.Tensor:
        """The serving read-out ``forward(imgs)[-1][0]`` (B, H/4, W/4,
        oup_dim), without the last stack's coarser-scale trunks and heads
        that nothing reads (the JAX program drops the same dead work)."""
        return self._run(imgs, full=False)[-1][0]
