"""Plain IMHN ``PoseNet``: the network's forward in float32 (or float64).

A frozen, stripped copy of the port's ``models/imhn.py`` ``PoseNet`` with
``cross_stack=True`` and no extra attention, the variant of every
configuration the benchmark runs: no int8 modes, no bands of rows, no
remat, no cast to a lower compute type. Module and parameter names are the
reference's (models/posenet.py:50-144), so the program's model and this one
load one state dict. Tensors are NCHW inside and NHWC at the boundary, as
in the program.

``lower`` (a function of a tensor, or None) rounds where the program's
network computed in a lower type rounds: every conv's and linear's input,
weight and output, each block's output after BatchNorm and again after its
activation, the SE gate, and every sum of branches. The precision control runs the network in fp8 through it
(``fp8_round``); ``bf16_round`` gives the plain network in bf16, the scale
the serving comparison measures the program's gap in.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.01
BN_EPS = 1e-5
FP8_MAX = 448.0          # largest finite float8_e4m3fn

Lower = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    abs-max at the format's largest value), in ``t``'s type."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


class _Round(torch.autograd.Function):
    """A tensor rounded to a lower type on the way forward, and its
    gradient rounded to the same type on the way back: a step computed in
    that type, forward and backward."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float8 e4m3 (one scale a tensor), its gradient too."""
    return _Round.apply(x, _fp8)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` in bfloat16, its gradient too."""
    return _Round.apply(x, _bf16)


class Ctx:
    """What one forward needs besides the input: BatchNorm's mode (a dict
    receives the batch statistics in train mode; None uses the running
    statistics) and the precision of the convs; the forward leaves the
    stem's output in ``stem``."""

    def __init__(self, bn_stats: Optional[Dict] = None, lower: Lower = None):
        self.bn_stats = bn_stats
        self.lower = lower
        self.stem: Optional[torch.Tensor] = None    # the stem's output, NCHW

    def round(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.lower is None else self.lower(t)

    def conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        w = conv.weight
        if self.lower is not None:
            x, w = self.lower(x), self.lower(w)
        return self.round(F.conv2d(x, w, conv.bias, conv.stride, conv.padding,
                                   conv.dilation))

    def linear(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        w = lin.weight
        if self.lower is not None:
            x, w = self.lower(x), self.lower(w)
        return self.round(F.linear(x, w, lin.bias))

    def bn(self, bn: nn.BatchNorm2d, y: torch.Tensor) -> torch.Tensor:
        if self.bn_stats is None:
            mean, var = bn.running_mean, bn.running_var
        else:
            var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
            self.bn_stats[bn] = (mean.detach(), var.detach())
        mul = torch.rsqrt(var + BN_EPS) * bn.weight
        return (y - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]


def conv_bn(ctx: Ctx, conv: nn.Conv2d, bn: Optional[nn.BatchNorm2d],
            x: torch.Tensor, relu: bool) -> torch.Tensor:
    y = ctx.conv(conv, x)
    if bn is not None:
        y = ctx.round(ctx.bn(bn, y))
    return ctx.round(F.leaky_relu(y, LEAKY_SLOPE)) if relu else y


class Conv(nn.Module):
    def __init__(self, ins: int, outs: int, k: int = 3, stride: int = 1,
                 bn: bool = True, relu: bool = True, dilation: int = 1,
                 device=None):
        super().__init__()
        pad = dilation * (k - 1) // 2
        self.conv = nn.Conv2d(ins, outs, k, stride, pad, bias=not bn,
                              dilation=dilation, device=device)
        self.bn = nn.BatchNorm2d(outs, device=device) if bn else None
        self.relu = relu

    def run(self, ctx: Ctx, x):
        return conv_bn(ctx, self.conv, self.bn, x, self.relu)


class Residual(nn.Module):
    def __init__(self, ins: int, outs: int, device=None):
        super().__init__()
        mid = outs // 2
        d = dict(device=device)
        self.convBlock = nn.Sequential(
            nn.Conv2d(ins, mid, 1, bias=False, **d), nn.BatchNorm2d(mid, **d),
            nn.LeakyReLU(LEAKY_SLOPE),
            nn.Conv2d(mid, mid, 3, 1, 1, bias=False, **d), nn.BatchNorm2d(mid, **d),
            nn.LeakyReLU(LEAKY_SLOPE),
            nn.Conv2d(mid, outs, 1, bias=False, **d), nn.BatchNorm2d(outs, **d))
        self.skipConv = (nn.Sequential(nn.Conv2d(ins, outs, 1, bias=False, **d),
                                       nn.BatchNorm2d(outs, **d))
                         if ins != outs else None)

    def run(self, ctx: Ctx, x):
        cb = self.convBlock
        h = conv_bn(ctx, cb[0], cb[1], x, True)
        h = conv_bn(ctx, cb[3], cb[4], h, True)
        h = conv_bn(ctx, cb[6], cb[7], h, False)
        if self.skipConv is not None:
            x = conv_bn(ctx, self.skipConv[0], self.skipConv[1], x, False)
        return ctx.round(F.leaky_relu(ctx.round(h + x), LEAKY_SLOPE))


class SELayer(nn.Module):
    def __init__(self, c: int, reduction: int = 16, device=None):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(c, c // reduction, device=device),
            nn.LeakyReLU(LEAKY_SLOPE),
            nn.Linear(c // reduction, c, device=device), nn.Sigmoid())

    def run(self, ctx: Ctx, x):
        y = x.mean(dim=(2, 3))
        y = ctx.round(F.leaky_relu(ctx.linear(self.fc[0], y), LEAKY_SLOPE))
        y = ctx.round(torch.sigmoid(ctx.linear(self.fc[2], y)))
        return ctx.round(x * y[:, :, None, None])


class Backbone(nn.Module):
    def __init__(self, out_dim: int, device=None):
        super().__init__()
        q, h = out_dim // 4, out_dim // 2
        self.conv1 = nn.Conv2d(3, q, 7, 2, 3, bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(q, device=device)
        self.res1 = Residual(q, h, device=device)
        self.res2 = Residual(h, h, device=device)
        self.dilation = nn.Sequential(*[Conv(h, h, 3, dilation=d, device=device)
                                        for d in (3, 3, 4, 4, 5, 5)])

    def run(self, ctx: Ctx, x):
        x = conv_bn(ctx, self.conv1, self.bn1, x, True)
        x = self.res2.run(ctx, F.max_pool2d(self.res1.run(ctx, x), 2, 2))
        h = x
        for conv in self.dilation:
            h = conv.run(ctx, h)
        return torch.cat([x, h], dim=1)


class Hourglass(nn.Module):
    def __init__(self, depth: int, nfeat: int, increase: int, device=None):
        super().__init__()
        self.depth = depth
        levels = []
        for d in range(depth):
            c = nfeat + increase * d
            cn = c + increase
            mods = [Residual(c, c, device), Residual(c, cn, device),
                    Residual(cn, c, device), Conv(c, c, 3, device=device)]
            if d == depth - 1:
                mods.append(Residual(cn, cn, device))
            levels.append(nn.ModuleList(mods))
        self.hg = nn.ModuleList(levels)

    def _level(self, ctx: Ctx, d: int, x, downs: List[torch.Tensor]):
        mods = self.hg[d]
        up1 = mods[0].run(ctx, x)
        low = mods[1].run(ctx, F.max_pool2d(x, 2, 2))
        low2 = (mods[4].run(ctx, low) if d == self.depth - 1
                else self._level(ctx, d + 1, low, downs))
        downs.append(low2)
        low3 = mods[2].run(ctx, low2)
        up = F.interpolate(low3, scale_factor=2, mode="nearest")
        return ctx.round(up1 + mods[3].run(ctx, up))

    def run(self, ctx: Ctx, x):
        downs: List[torch.Tensor] = []
        top = self._level(ctx, 0, x, downs)
        return [top] + downs[::-1]


class Features(nn.Module):
    def __init__(self, inp_dim: int, increase: int, num_scales: int,
                 reduction: int, device=None):
        super().__init__()
        self.before_regress = nn.ModuleList([
            nn.Sequential(Conv(inp_dim + i * increase, inp_dim, 3, device=device),
                          Conv(inp_dim, inp_dim, 3, device=device),
                          SELayer(inp_dim, reduction, device=device))
            for i in range(num_scales)])


class Merge(nn.Module):
    def __init__(self, x_dim: int, y_dim: int, device=None):
        super().__init__()
        self.conv = Conv(x_dim, y_dim, 1, relu=False, device=device)

    def run(self, ctx: Ctx, x):
        return self.conv.run(ctx, x)


class PoseNet(nn.Module):
    """``nstack`` hourglass stacks with cross-stack merges. ``run(imgs)``:
    imgs (B, H, W, 3) in [0, 1] -> [nstack][num_scales] NHWC maps with
    ``oup_dim`` channels; ``full=False`` computes only what the serving
    read-out ``[-1][0]`` needs."""

    def __init__(self, nstack: int, inp_dim: int, increase: int, depth: int,
                 oup_dim: int, se_reduction: int = 16, device=None):
        super().__init__()
        self.nstack, self.num_scales = nstack, depth + 1
        S = self.num_scales
        self.pre = Backbone(inp_dim, device)
        self.hourglass = nn.ModuleList()
        self.features = nn.ModuleList()
        self.outs = nn.ModuleList()
        self.merge_features = nn.ModuleList()
        self.merge_preds = nn.ModuleList()
        for t in range(nstack):
            self.hourglass.append(Hourglass(depth, inp_dim, increase, device))
            self.features.append(Features(inp_dim, increase, S, se_reduction,
                                          device))
            self.outs.append(nn.ModuleList([
                Conv(inp_dim, oup_dim, 1, bn=False, relu=False, device=device)
                for _ in range(S)]))
            if t < nstack - 1:
                self.merge_features.append(nn.ModuleList([
                    Merge(inp_dim, inp_dim + j * increase, device) for j in range(S)]))
                self.merge_preds.append(nn.ModuleList([
                    Merge(oup_dim, inp_dim + j * increase, device) for j in range(S)]))

    def run(self, imgs: torch.Tensor, ctx: Optional[Ctx] = None,
            full: bool = True) -> List[List[torch.Tensor]]:
        ctx = ctx or Ctx()
        x = ctx.stem = self.pre.run(ctx, imgs.permute(0, 3, 1, 2))
        preds: List[List[torch.Tensor]] = []
        caches: List[Optional[torch.Tensor]] = [None] * self.num_scales
        for t in range(self.nstack):
            last = t == self.nstack - 1
            hg = self.hourglass[t].run(ctx, x)
            stack = []
            for s in (range(self.num_scales) if (full or not last) else (0,)):
                h = hg[s]
                if t > 0:
                    h = ctx.round(h + caches[s])
                trunk = self.features[t].before_regress[s]
                feat = trunk[2].run(ctx, trunk[1].run(ctx, trunk[0].run(ctx, h)))
                pred = self.outs[t][s].run(ctx, feat)
                stack.append(pred)
                if not last:
                    cache = ctx.round(self.merge_preds[t][s].run(ctx, pred)
                                      + self.merge_features[t][s].run(ctx, feat))
                    if s == 0:
                        x = ctx.round(x + cache)
                    caches[s] = cache
            preds.append(stack)
        return [[p.permute(0, 2, 3, 1) for p in st] for st in preds]

    def predict_maps(self, imgs: torch.Tensor, lower: Lower = None) -> torch.Tensor:
        """The serving read-out with running BN statistics: (B, H/4, W/4, 50)."""
        return self.run(imgs, Ctx(None, lower), full=False)[-1][0]


def build(model_cfg: dict, device=None) -> PoseNet:
    """The network of a configuration file's ``model`` group."""
    return PoseNet(model_cfg["nstack"], model_cfg["inp_dim"],
                   model_cfg["increase"], model_cfg["depth"],
                   model_cfg["oup_dim"], model_cfg["se_reduction"], device=device)
