"""IMHN (Identity-Mapping Hourglass Network) ``PoseNet`` in PyTorch, its
variants and their int8 post-training quantization modes.

Port of ``improved_body_parts_tpu/models/imhn.py``: the live ``PoseNet``
(:51-328) with its ``extra_attention`` and ``cross_stack=False`` variants,
``LegacyHourglass`` and ``IndependentPoseNet`` (:331-414) and
``create_model`` (:417-423). ``PoseNet``'s module and attribute names are
the reference's (models/posenet.py:50-144, models/layers_transposed.py:
12-310), so ``load_state_dict(strict=True)`` takes a released reference
``.pth``, the output of the JAX package's ``export_to_torch_state_dict`` and
the test mirror's ``TPoseNet`` state_dict alike; the reference has no names
for ``chattn`` (``chattn.<t>.<s>``) or ``IndependentPoseNet``, whose modules
carry the Flax names (``utils/checkpoint.py`` maps them).

``quant`` selects the post-training-quantization modes of ``PoseNet``
(``models/quantize.py`` builds the weights): every conv block's
convolution is a ``QConv2d`` on BN-folded weights and its BatchNorm is
gone; ``"calib"`` runs it in ``compute_dtype`` and records its input's fp32
abs-max, ``"int8"`` runs ``ops.kernels.int8_conv`` (a residual's chain
passes int8 between its convs, ``Residual.int8_links``). The SE linears
stay in ``compute_dtype``, as in JAX.

Precision follows the JAX model: parameters are stored in fp32; convs and
linears run in ``compute_dtype`` (bf16 by default) on weights cast at the
call; BatchNorm math runs in fp32 (eps 1e-5) and is cast back; the SE mean is
taken in fp32; outputs are cast to fp32. A float64 model (``.double()``,
``compute_dtype=torch.float64``) keeps float64 throughout: it is the
reference the tests hold the train-mode step against.

BatchNorm mode is an explicit argument, ``forward(imgs, train=...)``, as in
the JAX model's ``__call__(imgs, train=False)``; ``nn.Module.training`` is
never read, so a module left in training mode still serves on running
statistics. In train mode (``train=True``, or a ``bn_stats`` dict given)
each BatchNorm normalizes with the batch's fp32 mean and biased variance
over (N, H, W) and records them in ``bn_stats``, keyed by the
``BatchNorm2d`` module; the forward leaves
the running statistics alone and the train step commits them
(``train_lib``), so a skipped step and a recomputed (``remat``) hourglass
leave them right. Convs are
``torch.nn.functional.conv2d`` (cuDNN on the card), as the JAX package left
them to XLA. Public tensors are NHWC like the JAX model's; inside, tensors
are NCHW, and ``channels_last`` in memory when the input and the module are.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from improved_body_parts_tpu_torch.configs import ModelConfig
from improved_body_parts_tpu_torch.ops import kernels
from improved_body_parts_tpu_torch.parallel import spatial
from improved_body_parts_tpu_torch.parallel.mesh import global_var_mean
from improved_body_parts_tpu_torch.parallel.spatial import RowShard, scale_rows

LEAKY_SLOPE = 0.01
BN_EPS = 1e-5
# reference init: conv kernels ~ N(0, 0.001), SE linears ~ N(0, 0.01)
# (models/posenet.py:124-144)
CONV_INIT_STD = 0.001
DENSE_INIT_STD = 0.01

# {BatchNorm2d: (batch mean, batch biased variance)} in ``wide`` type,
# detached; None selects inference mode (running statistics). A
# ``quant="calib"`` model, which has no BatchNorm, records {QConv2d: input
# abs-max} in the same dict.
BNStats = Optional[Dict[nn.Module, object]]
# the spatial context (``parallel/spatial.RowShard``): None, or this rank's
# band of the rows on a spatial mesh (replicated: a gathered level)
Rows = Optional[RowShard]
QUANT_MODES = (None, "calib", "int8")


def wide(dt: torch.dtype) -> torch.dtype:
    """The type BN statistics, the SE mean and the outputs are kept in:
    fp32, or float64 for a float64 model."""
    return torch.promote_types(dt, torch.float32)


class QConv2d(nn.Module):
    """The convolution of a BN-folded conv block in a quant mode (the JAX
    ``ConvBlock(quant=...)``, models/imhn.py:56-129):

      * ``"calib"``: fp32 ``weight`` (OIHW) and ``bias`` with the BN folded
        in, run in ``x.dtype``; the input's fp32 abs-max is recorded in the
        dict the forward is given (the max over calls).
      * ``"int8"``: buffers ``weight_q`` (Cout, kh*kw*Cin) int8 in (ky, kx,
        ci) order, ``bias`` and ``w_scale`` (Cout,) and ``a_scale`` ()
        float32; the forward is ``ops.kernels.int8_conv`` on the NHWC view
        of a channels_last input. The input may be int8, already quantized
        with ``a_scale`` (then ``out_dtype`` names the compute type), and
        with ``a_next`` the output is int8, quantized with the next conv's
        scale (``Residual.int8_links``).
    """

    def __init__(self, ins: int, outs: int, k: int, stride: int, padding: int,
                 dilation: int, quant: str, device=None):
        super().__init__()
        self.quant, self.k, self.ins, self.outs = quant, k, ins, outs
        self.stride, self.padding, self.dilation = stride, padding, dilation
        if quant == "calib":
            self.weight = nn.Parameter(torch.zeros(outs, ins, k, k, device=device))
            self.bias = nn.Parameter(torch.zeros(outs, device=device))
        elif quant == "int8":
            self.register_buffer("weight_q", torch.zeros(
                outs, k * k * ins, dtype=torch.int8, device=device))
            self.register_buffer("bias", torch.zeros(outs, device=device))
            self.register_buffer("w_scale", torch.ones(outs, device=device))
            self.register_buffer("a_scale", torch.ones((), device=device))
        else:
            raise ValueError(f"unknown quant mode {quant!r}")

    @property
    def int8_io(self) -> bool:
        """Whether this conv's kernel takes int8 input and writes int8
        output (``kernels.int8_conv_route``): decided by its shape."""
        return kernels.int8_conv_route(self.ins, self.stride, int8_io=True) == "wgmma"

    def forward(self, x, relu: bool, stats: BNStats = None, a_next=None,
                out_dtype=None):
        if self.quant == "calib":
            if stats is not None:
                m = x.detach().float().abs().amax()
                prev = stats.get(self)
                stats[self] = m if prev is None else torch.maximum(prev, m)
            dt = x.dtype
            y = F.conv2d(x, self.weight.to(dt), self.bias.to(dt), self.stride,
                         self.padding, self.dilation)
            return F.leaky_relu(y, LEAKY_SLOPE) if relu else y
        w = self.weight_q.view(self.outs, self.k, self.k, self.ins)
        y = kernels.int8_conv(x.permute(0, 2, 3, 1).contiguous(), w, self.bias,
                              self.w_scale, self.a_scale, self.stride,
                              self.padding, self.dilation, relu, out_dtype, a_next)
        return y.permute(0, 3, 1, 2)


def make_conv(ins: int, outs: int, k: int, stride: int = 1, padding: int = 0,
              dilation: int = 1, bias: bool = False, quant: Optional[str] = None,
              device=None) -> nn.Module:
    """A conv block's convolution: ``nn.Conv2d``, or a ``QConv2d`` (which
    always has a bias: it carries the folded BN shift) in a quant mode."""
    if quant is None:
        return nn.Conv2d(ins, outs, k, stride, padding, bias=bias,
                         dilation=dilation, device=device)
    return QConv2d(ins, outs, k, stride, padding, dilation, quant, device)


def make_bn(c: int, quant: Optional[str] = None, device=None) -> nn.Module:
    """A conv block's BatchNorm, or ``nn.Identity`` where a quant mode has
    folded it into the conv (module positions stay the reference's)."""
    return nn.BatchNorm2d(c, device=device) if quant is None else nn.Identity()


def conv_bn(conv: nn.Module, bn: Optional[nn.Module], x: torch.Tensor,
            relu: bool, bn_stats: BNStats = None, rows: Rows = None) -> torch.Tensor:
    """conv in ``x.dtype`` -> [BN in ``wide(x.dtype)``, cast back] -> [LeakyReLU].
    With ``bn_stats`` (train mode) BN uses the batch's statistics and
    records them there; without, the running statistics. A ``QConv2d``
    (no BN) runs the whole block. With ``rows`` the conv runs on this
    rank's band (``parallel/spatial.conv2d``: halo'd rows) and train-mode
    statistics are the global batch's whole images (a gathered level's over
    the data group alone, so it counts once)."""
    if isinstance(conv, QConv2d):
        if rows is not None:
            raise ValueError("quantized convs do not run on bands of rows")
        return conv(x, relu, bn_stats)
    dt = x.dtype
    bias = None if conv.bias is None else conv.bias.to(dt)
    y = spatial.conv2d(x, conv.weight.to(dt), bias, conv.stride, conv.padding,
                       conv.dilation, rows)
    if bn is not None:
        y32 = y.to(wide(dt))
        if bn_stats is None:
            mean, var = bn.running_mean, bn.running_var
        else:
            # two-pass variance (Flax takes E[x^2] - E[x]^2, which loses
            # digits when |mean| >> std); biased, as Flax records it; over
            # the global batch in a data-parallel step (BatchStats)
            group = getattr(bn_stats, "group", None)
            if rows is not None and rows.replicated:
                group = rows.data_group
            if group is None:
                var, mean = torch.var_mean(y32, dim=(0, 2, 3), correction=0)
            else:
                mean, var = global_var_mean(y32, group)
            bn_stats[bn] = (mean.detach(), var.detach())
        mul = torch.rsqrt(var + BN_EPS) * bn.weight
        y = ((y32 - mean[:, None, None]) * mul[:, None, None]
             + bn.bias[:, None, None]).to(dt)
    return F.leaky_relu(y, LEAKY_SLOPE) if relu else y


class Conv(nn.Module):
    """conv -> [BN] -> [LeakyReLU]; bias only when BN is off.
    reference: models/layers_transposed.py:90-157 (``Conv``/``DilatedConv``)."""

    def __init__(self, ins: int, outs: int, k: int = 3, stride: int = 1,
                 bn: bool = True, relu: bool = True, dilation: int = 1,
                 device=None, quant: Optional[str] = None):
        super().__init__()
        pad = dilation * (k - 1) // 2
        self.conv = make_conv(ins, outs, k, stride, pad, dilation, not bn,
                              quant, device)
        self.bn = make_bn(outs, quant, device) if bn else None
        self.relu = nn.LeakyReLU(LEAKY_SLOPE) if relu else None

    def forward(self, x, bn_stats: BNStats = None, rows: Rows = None):
        return conv_bn(self.conv, self.bn, x, self.relu is not None, bn_stats,
                       rows)


class Residual(nn.Module):
    """Bottleneck residual 1x1 -> 3x3 -> 1x1 with an identity (or 1x1) skip.
    reference: models/layers_transposed.py:12-48.

    In the int8 mode each conv of the chain feeds only the next, so where
    both ends of a link take int8 (``QConv2d.int8_io``) the producer writes
    its output quantized with the consumer's ``a_scale`` (``int8_links``,
    conv 0 -> 3 and 3 -> 6): the bytes the consumer would make from the
    ``compute_dtype`` tensor, which is then never written. None outside the
    int8 mode."""

    def __init__(self, ins: int, outs: int, device=None,
                 quant: Optional[str] = None):
        super().__init__()
        mid = outs // 2
        q = dict(quant=quant, device=device)
        self.convBlock = nn.Sequential(
            make_conv(ins, mid, 1, **q), make_bn(mid, **q), nn.LeakyReLU(LEAKY_SLOPE),
            make_conv(mid, mid, 3, 1, 1, **q), make_bn(mid, **q),
            nn.LeakyReLU(LEAKY_SLOPE),
            make_conv(mid, outs, 1, **q), make_bn(outs, **q))
        if ins != outs:
            self.skipConv = nn.Sequential(make_conv(ins, outs, 1, **q),
                                          make_bn(outs, **q))
        else:
            self.skipConv = None
        self.int8_links = self.fusable_links() if quant == "int8" else None

    def fusable_links(self, fused: bool = True) -> tuple:
        """(conv 0 -> 3, conv 3 -> 6): where both ends take int8, by shape;
        neither unless ``fused``."""
        io = [self.convBlock[i].int8_io for i in (0, 3, 6)]
        return (fused and io[0] and io[1], fused and io[1] and io[2])

    def forward(self, x, bn_stats: BNStats = None, rows: Rows = None):
        cb = self.convBlock
        if self.int8_links is not None:
            fuse0, fuse1 = self.int8_links
            dt = x.dtype
            h = cb[0](x, True, a_next=cb[3].a_scale if fuse0 else None)
            h = cb[3](h, True, a_next=cb[6].a_scale if fuse1 else None,
                      out_dtype=dt if fuse0 else None)
            h = cb[6](h, False, out_dtype=dt if fuse1 else None)
        else:
            h = conv_bn(cb[0], cb[1], x, True, bn_stats, rows)
            h = conv_bn(cb[3], cb[4], h, True, bn_stats, rows)
            h = conv_bn(cb[6], cb[7], h, False, bn_stats, rows)
        if self.skipConv is not None:
            x = conv_bn(self.skipConv[0], self.skipConv[1], x, False, bn_stats,
                        rows)
        return F.leaky_relu(h + x, LEAKY_SLOPE)


class SELayer(nn.Module):
    """Squeeze-and-excitation. reference: layers_transposed.py:289-310."""

    def __init__(self, c: int, reduction: int = 16, device=None):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(c, c // reduction, device=device),
            nn.LeakyReLU(LEAKY_SLOPE),
            nn.Linear(c // reduction, c, device=device), nn.Sigmoid())

    def forward(self, x, rows: Rows = None):
        dt = x.dtype
        fc1, fc2 = self.fc[0], self.fc[2]
        if rows is None or rows.replicated:
            y = x.to(wide(dt)).mean(dim=(2, 3)).to(dt)     # global pool in fp32
        else:   # the bands' sums over the spatial group, over the whole image
            y = (rows.sum(x.to(wide(dt)).sum(dim=(2, 3)))
                 / (x.shape[2] * rows.size * x.shape[3])).to(dt)
        y = F.leaky_relu(F.linear(y, fc1.weight.to(dt), fc1.bias.to(dt)),
                         LEAKY_SLOPE)
        y = torch.sigmoid(F.linear(y, fc2.weight.to(dt), fc2.bias.to(dt)))
        return x * y[:, :, None, None]


def max_pool2(x):
    return F.max_pool2d(x, 2, 2)


def upsample_nearest2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _pool_rows(x, rows: Rows):
    """An hourglass level's way down: (``max_pool2(x)``, the next level's
    context). A band with an odd number of rows cannot be halved locally:
    it is gathered first, and the levels below run replicated
    (``parallel/spatial.split_at``)."""
    if rows is not None and not rows.replicated and x.shape[2] % 2:
        return max_pool2(rows.gather(x)), rows.full
    return max_pool2(x), rows


def _up_rows(x, rows: Rows, inner: Rows):
    """The way back up: ``upsample_nearest2(x)``, cut to this rank's band
    where the level below ran replicated."""
    up = upsample_nearest2(x)
    return rows.own(up) if inner is not rows else up


class Backbone(nn.Module):
    """Dilated stem -> ``out_dim`` channels at stride 4.
    reference: layers_transposed.py:160-196."""

    def __init__(self, out_dim: int = 256, device=None,
                 quant: Optional[str] = None):
        super().__init__()
        q, h = out_dim // 4, out_dim // 2
        self.conv1 = make_conv(3, q, 7, 2, 3, quant=quant, device=device)
        self.bn1 = make_bn(q, quant, device)
        self.res1 = Residual(q, h, device=device, quant=quant)
        self.res2 = Residual(h, h, device=device, quant=quant)
        self.dilation = nn.Sequential(*[
            Conv(h, h, 3, dilation=d, device=device, quant=quant)
            for d in (3, 3, 4, 4, 5, 5)])

    def forward(self, x, bn_stats: BNStats = None, rows: Rows = None):
        x = conv_bn(self.conv1, self.bn1, x, True, bn_stats, rows)
        x = self.res2(max_pool2(self.res1(x, bn_stats, rows)), bn_stats, rows)
        h = x
        for conv in self.dilation:
            h = conv(h, bn_stats, rows)
        return torch.cat([x, h], dim=1)


class Hourglass(nn.Module):
    """Recursive hourglass returning ``depth + 1`` scales, finest first.
    reference: layers_transposed.py:199-286; per level ``hg[d]`` holds
    [up1, low1, low2, refine conv, (inner, deepest level only)]."""

    def __init__(self, depth: int, nfeat: int, increase: int, device=None,
                 quant: Optional[str] = None):
        super().__init__()
        self.depth = depth
        q = dict(device=device, quant=quant)
        levels = []
        for d in range(depth):
            c = nfeat + increase * d
            cn = c + increase
            mods = [Residual(c, c, **q), Residual(c, cn, **q),
                    Residual(cn, c, **q), Conv(c, c, 3, **q)]
            if d == depth - 1:
                mods.append(Residual(cn, cn, **q))
            levels.append(nn.ModuleList(mods))
        self.hg = nn.ModuleList(levels)

    def _level(self, d: int, x, downs: List[torch.Tensor], bn_stats: BNStats,
               rows: Rows):
        mods = self.hg[d]
        up1 = mods[0](x, bn_stats, rows)
        pooled, inner = _pool_rows(x, rows)
        low = mods[1](pooled, bn_stats, inner)
        low2 = (mods[4](low, bn_stats, inner) if d == self.depth - 1
                else self._level(d + 1, low, downs, bn_stats, inner))
        downs.append(low2)                      # innermost appended first
        low3 = mods[2](low2, bn_stats, inner)
        return up1 + mods[3](_up_rows(low3, rows, inner), bn_stats, rows)

    def forward(self, x, bn_stats: BNStats = None, rows: Rows = None):
        downs: List[torch.Tensor] = []
        top = self._level(0, x, downs, bn_stats, rows)
        return [top] + downs[::-1]


class Features(nn.Module):
    """Per-scale regression trunks Conv3x3 -> Conv3x3 -> SE.
    reference: posenet.py:25-47."""

    def __init__(self, inp_dim: int, increase: int, num_scales: int,
                 reduction: int = 16, device=None, quant: Optional[str] = None):
        super().__init__()
        q = dict(device=device, quant=quant)
        self.before_regress = nn.ModuleList([
            nn.Sequential(Conv(inp_dim + i * increase, inp_dim, 3, **q),
                          Conv(inp_dim, inp_dim, 3, **q),
                          SELayer(inp_dim, reduction, device=device))
            for i in range(num_scales)])


class Merge(nn.Module):
    """1x1 conv + BN cross-stack merge (reference ``Merge``)."""

    def __init__(self, x_dim: int, y_dim: int, device=None,
                 quant: Optional[str] = None):
        super().__init__()
        self.conv = Conv(x_dim, y_dim, 1, relu=False, device=device, quant=quant)

    def forward(self, x, bn_stats: BNStats = None, rows: Rows = None):
        return self.conv(x, bn_stats, rows)


class _PoseNetBase(nn.Module):
    """What every network of the port shares: the reference init, the
    BatchNorm-mode protocol of ``forward`` and the serving read-out.
    Subclasses build ``_run(imgs, full, bn_stats, rows)``."""

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

    def _init(self, device, generator):
        if torch.device(device or "cpu").type != "meta":
            self.reset_parameters(generator)

    def _outputs(self, preds: List[List[torch.Tensor]]) -> List[List[torch.Tensor]]:
        return [[p.to(wide(p.dtype)).permute(0, 2, 3, 1) for p in st]
                for st in preds]

    def forward(self, imgs: torch.Tensor, train: bool = False,
                bn_stats: BNStats = None, rows: Rows = None
                ) -> List[List[torch.Tensor]]:
        """imgs (B, H, W, 3) in [0, 1] -> [nstack][num_scales] NHWC fp32.
        A ``bn_stats`` dict selects train mode and receives the batch
        statistics (the running statistics stay as they are); ``train=True``
        alone is train mode with the statistics dropped. Otherwise BN uses
        the running statistics. A ``quant="calib"`` model records its conv
        blocks' input abs-max in ``bn_stats`` instead. ``rows``: ``imgs``
        is this rank's band of the rows (a multiple of 4 of them) on a
        spatial mesh; each output scale is then this rank's band of it, or
        the whole scale where it is too short to split
        (``parallel/spatial.split_at``)."""
        if train and bn_stats is None:
            bn_stats = {}
        if rows is not None and imgs.shape[1] % 4:
            raise ValueError(f"a band of {imgs.shape[1]} rows: the stem and "
                             "the pool need a multiple of 4")
        return self._run(imgs, full=True, bn_stats=bn_stats, rows=rows)

    def predict_maps(self, imgs: torch.Tensor) -> torch.Tensor:
        """The serving read-out ``forward(imgs)[-1][0]`` (B, H/4, W/4,
        oup_dim), without the work nothing reads (the JAX program drops the
        same dead work)."""
        return self._run(imgs, full=False)[-1][0]


class PoseNet(_PoseNetBase):
    """Multi-stack IMHN. Input NHWC images in [0, 1]; ``forward`` returns
    ``[nstack][num_scales]`` NHWC fp32 maps with ``oup_dim`` channels.

    ``compute_dtype`` is the type convs and linears run in (bf16 for
    serving, fp32 for parity checks). Weights start from the reference init
    drawn from ``generator`` (which must live on ``device``), or stay
    uninitialised on the ``meta`` device. ``cfg.extra_attention`` adds an
    SE layer on each hourglass output (``chattn[t][s]``, before the
    cross-stack add); ``cfg.cross_stack=False`` builds no merges. ``quant``
    is None, ``"calib"`` or ``"int8"`` (module docstring)."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), *, device=None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 quant: Optional[str] = None):
        super().__init__()
        if cfg.legacy_blocks:
            raise ValueError("legacy_blocks builds IndependentPoseNet: use "
                             "create_model")
        if quant not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {quant!r}")
        if cfg.num_scales != cfg.depth + 1:
            raise ValueError(f"num_scales {cfg.num_scales} != depth + 1")
        self.cfg = cfg
        self.quant = quant
        self.compute_dtype = compute_dtype
        inp, inc, S = cfg.inp_dim, cfg.increase, cfg.num_scales
        q = dict(device=device, quant=quant)
        self.pre = Backbone(inp, **q)
        self.hourglass = nn.ModuleList()
        self.features = nn.ModuleList()
        self.outs = nn.ModuleList()
        self.merge_features = nn.ModuleList()
        self.merge_preds = nn.ModuleList()
        self.chattn = nn.ModuleList() if cfg.extra_attention else None
        for t in range(cfg.nstack):
            self.hourglass.append(Hourglass(cfg.depth, inp, inc, **q))
            if cfg.extra_attention:
                self.chattn.append(nn.ModuleList([
                    SELayer(inp + s * inc, cfg.se_reduction, device=device)
                    for s in range(S)]))
            self.features.append(Features(inp, inc, S, cfg.se_reduction, **q))
            self.outs.append(nn.ModuleList([
                Conv(inp, cfg.oup_dim, 1, bn=False, relu=False, **q)
                for _ in range(S)]))
            if cfg.cross_stack and t < cfg.nstack - 1:
                self.merge_features.append(nn.ModuleList([
                    Merge(inp, inp + j * inc, **q) for j in range(S)]))
                self.merge_preds.append(nn.ModuleList([
                    Merge(cfg.oup_dim, inp + j * inc, **q) for j in range(S)]))
        self._init(device, generator)

    def _run(self, imgs: torch.Tensor, full: bool, bn_stats: BNStats = None,
             rows: Rows = None) -> List[List[torch.Tensor]]:
        cfg = self.cfg
        cross = cfg.cross_stack
        x = self.pre(imgs.permute(0, 3, 1, 2).to(self.compute_dtype), bn_stats,
                     rows)
        preds: List[List[torch.Tensor]] = []
        caches: List[Optional[torch.Tensor]] = [None] * cfg.num_scales
        # remat: each hourglass is recomputed in the backward pass (the JAX
        # model's nn.remat over Hourglass); the recompute records the same
        # batch statistics again under the same keys, and on a spatial mesh
        # makes its exchanges again, in the same order on every rank. The
        # network draws no random numbers, so no RNG state is saved for the
        # recompute (which a step captured in a CUDA graph could not read)
        remat = cfg.remat and torch.is_grad_enabled()
        # without cross-stack merges no stack feeds the next, so the serving
        # read-out needs the last stack alone
        stacks = range(cfg.nstack) if (full or cross) else (cfg.nstack - 1,)
        for t in stacks:
            last = t == cfg.nstack - 1
            if remat:
                hg = checkpoint(self.hourglass[t], x, bn_stats, rows,
                                use_reentrant=False, preserve_rng_state=False)
            else:
                hg = self.hourglass[t](x, bn_stats, rows)
            # the last stack's coarser scales feed nothing when only the
            # final scale-0 map is read
            scales = range(cfg.num_scales) if (full or not last) else (0,)
            stack = []
            for s in scales:
                h = hg[s]
                r = scale_rows(rows, hg[0].shape[2], s)
                if self.chattn is not None:
                    h = self.chattn[t][s](h, r)
                if cross and t > 0:
                    h = h + caches[s]
                trunk = self.features[t].before_regress[s]
                feat = trunk[2](trunk[1](trunk[0](h, bn_stats, r), bn_stats, r), r)
                pred = self.outs[t][s](feat, bn_stats, r)
                stack.append(pred)
                if cross and not last:
                    cache = (self.merge_preds[t][s](pred, bn_stats, r)
                             + self.merge_features[t][s](feat, bn_stats, r))
                    if s == 0:
                        x = x + cache
                    caches[s] = cache
            preds.append(stack)
        return self._outputs(preds)


class LegacyHourglass(nn.Module):
    """The old (AE-style) hourglass: plain 3x3 conv blocks instead of
    residuals and no refine conv after the upsample. Returns ``depth + 1``
    scales, finest first. reference: models/layers.py:97-169; children
    carry the Flax names ``d<d>_{up1,low1,low2,inner}``."""

    def __init__(self, depth: int, nfeat: int, increase: int, device=None):
        super().__init__()
        self.depth = depth
        for d in range(depth):
            c = nfeat + increase * d
            cn = c + increase
            self.add_module(f"d{d}_up1", Conv(c, c, 3, device=device))
            self.add_module(f"d{d}_low1", Conv(c, cn, 3, device=device))
            if d == depth - 1:
                self.add_module(f"d{d}_inner", Conv(cn, cn, 3, device=device))
            self.add_module(f"d{d}_low2", Conv(cn, c, 3, device=device))

    def _level(self, d: int, x, downs: List[torch.Tensor], bn_stats: BNStats,
               rows: Rows):
        mod = lambda name: getattr(self, f"d{d}_{name}")
        up1 = mod("up1")(x, bn_stats, rows)
        pooled, inner = _pool_rows(x, rows)
        low = mod("low1")(pooled, bn_stats, inner)
        low2 = (mod("inner")(low, bn_stats, inner) if d == self.depth - 1
                else self._level(d + 1, low, downs, bn_stats, inner))
        downs.append(low2)                      # innermost appended first
        return up1 + _up_rows(mod("low2")(low2, bn_stats, inner), rows, inner)

    def forward(self, x, bn_stats: BNStats = None, rows: Rows = None):
        downs: List[torch.Tensor] = []
        top = self._level(0, x, downs, bn_stats, rows)
        return [top] + downs[::-1]


class IndependentPoseNet(_PoseNetBase):
    """The AE-family ablation network (reference
    models/posenet_independent.py:39-96; JAX models/imhn.py:365-414):
    plain-conv stem, ``LegacyHourglass``, per-scale-width features without
    SE, and only the scale-0 merges, without BN, chaining into the next
    stack's input. Children carry the Flax names (``pre0``..``pre3``,
    ``hg<t>``, ``feat<t>_s<s>{a,b}``, ``out<t>_s<s>``,
    ``merge_{pred,feat}<t>``)."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), *, device=None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.quant = None
        self.compute_dtype = compute_dtype
        inp, inc = cfg.inp_dim, cfg.increase
        self.pre0 = Conv(3, 64, 7, stride=2, device=device)
        self.pre1 = Conv(64, 128, 3, device=device)
        self.pre2 = Conv(128, 128, 3, device=device)
        self.pre3 = Conv(128, inp, 3, device=device)
        for t in range(cfg.nstack):
            self.add_module(f"hg{t}", LegacyHourglass(cfg.depth, inp, inc,
                                                      device=device))
            for s in range(cfg.num_scales):
                c = inp + s * inc
                self.add_module(f"feat{t}_s{s}a", Conv(c, c, 3, device=device))
                self.add_module(f"feat{t}_s{s}b", Conv(c, c, 3, device=device))
                self.add_module(f"out{t}_s{s}", Conv(c, cfg.oup_dim, 1, bn=False,
                                                    relu=False, device=device))
            if t < cfg.nstack - 1:
                self.add_module(f"merge_pred{t}", Conv(cfg.oup_dim, inp, 1, bn=False,
                                                       relu=False, device=device))
                self.add_module(f"merge_feat{t}", Conv(inp, inp, 1, bn=False,
                                                       relu=False, device=device))
        self._init(device, generator)

    def _run(self, imgs: torch.Tensor, full: bool, bn_stats: BNStats = None,
             rows: Rows = None) -> List[List[torch.Tensor]]:
        cfg = self.cfg
        x = imgs.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = self.pre1(self.pre0(x, bn_stats, rows), bn_stats, rows)
        x = self.pre3(self.pre2(max_pool2(x), bn_stats, rows), bn_stats, rows)
        preds: List[List[torch.Tensor]] = []
        for t in range(cfg.nstack):
            last = t == cfg.nstack - 1
            hg = getattr(self, f"hg{t}")(x, bn_stats, rows)
            # only scale 0 chains into the next stack: the serving read-out
            # needs no coarser scale's trunk or head
            stack = []
            for s in (range(cfg.num_scales) if full else (0,)):
                r = scale_rows(rows, hg[0].shape[2], s)
                f = getattr(self, f"feat{t}_s{s}a")(hg[s], bn_stats, r)
                f = getattr(self, f"feat{t}_s{s}b")(f, bn_stats, r)
                pred = getattr(self, f"out{t}_s{s}")(f, bn_stats, r)
                stack.append(pred)
                if s == 0 and not last:
                    x = (x + getattr(self, f"merge_pred{t}")(pred, bn_stats, r)
                         + getattr(self, f"merge_feat{t}")(f, bn_stats, r))
            preds.append(stack)
        return self._outputs(preds)


def create_model(cfg: ModelConfig = ModelConfig(), *, quant: Optional[str] = None,
                 device=None, compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None) -> _PoseNetBase:
    """The network of ``cfg`` (JAX ``create_model``, models/imhn.py:417-423):
    ``IndependentPoseNet`` for ``legacy_blocks``, which refuses ``quant``,
    else ``PoseNet``."""
    kw = dict(device=device, compute_dtype=compute_dtype, generator=generator)
    if cfg.legacy_blocks:
        if quant is not None:
            raise ValueError("quantization supports the live PoseNet only")
        return IndependentPoseNet(cfg, **kw)
    return PoseNet(cfg, quant=quant, **kw)
