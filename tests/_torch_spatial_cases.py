"""The network's conv forms on bands of rows, run inside the gloo ranks of
``tests/_torch_dist_child.py`` (``kind="spatial_ops"``): every rank of one
spatial group of S ranks takes its band of the same float64 input, runs
the op with ``parallel/spatial.RowShard``, and backpropagates its share of
an objective sum(y * R); the rank also runs the op unsharded on the whole
input. The output band, the input's gradient band and the weight gradients
summed over the ranks are compared with the unsharded op's, and each
case's largest error and the scale of its values are returned.

Train-mode BatchNorm (``BatchStats`` over the group) follows every conv, so
the statistics over the bands and their gradient are held too. The
gathered case is an hourglass level of depth 1 on one row a band: its way
down gathers the rows and its inner level runs replicated, its coarser
output whole on every rank (weighted 1/S in the objective, as the loss
counts a gathered scale). ``MODEL_CASES`` run whole tiny networks the same
way at 64² (every stack and scale an output): ``PoseNet`` with
``extra_attention`` and with ``cross_stack=False``, ``IndependentPoseNet``
and ``AEPoseNet``; with S = 4 the stride-4 map has 4 rows a band, so
the dilated convs (halo 5) and the coarser scales are gathered.
"""

import torch
import torch.distributed as dist

from improved_body_parts_tpu_torch.configs import ModelConfig
from improved_body_parts_tpu_torch.models import imhn
from improved_body_parts_tpu_torch.models.ae_pose import AEPoseNet
from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib
from improved_body_parts_tpu_torch.parallel.spatial import RowShard

B, W = 2, 8
CASES = ("stem_7x7_s2", "conv_3x3", "dilated_d5", "conv_1x1", "max_pool2",
         "upsample_nearest2", "se_layer", "gathered_1_row_level")
MODEL_CASES = ("posenet_extra_attention", "posenet_no_cross_stack",
               "independent_posenet", "ae_posenet")
TINY = dict(nstack=2, inp_dim=32, increase=16)


def _case(name):
    """(module or None, fn(module, x, bn_stats, rows) -> [outputs], input
    channels, input rows for S bands (or (rows, width)))."""
    c = 16
    if name == "stem_7x7_s2":
        return imhn.Conv(3, c, 7, stride=2), _conv, 3, lambda S: 8 * S
    if name == "conv_3x3":
        return imhn.Conv(c, c, 3), _conv, c, lambda S: 4 * S
    if name == "dilated_d5":
        return imhn.Conv(c, c, 3, dilation=5), _conv, c, lambda S: 6 * S
    if name == "conv_1x1":
        return imhn.Conv(c, c, 1), _conv, c, lambda S: 2 * S
    if name == "max_pool2":
        return None, lambda m, x, st, r: [imhn.max_pool2(x)], c, lambda S: 4 * S
    if name == "upsample_nearest2":
        return (None, lambda m, x, st, r: [imhn.upsample_nearest2(x)], c,
                lambda S: 2 * S)
    if name == "se_layer":
        return imhn.SELayer(c), lambda m, x, st, r: [m(x, r)], c, lambda S: 3 * S
    if name == "gathered_1_row_level":
        return (imhn.Hourglass(1, c, 8), lambda m, x, st, r: m(x, st, r), c,
                lambda S: S)
    flags = {"posenet_extra_attention": dict(extra_attention=True),
             "posenet_no_cross_stack": dict(cross_stack=False),
             "independent_posenet": dict(cross_stack=False, legacy_blocks=True),
             "ae_posenet": {}}
    cfg = ModelConfig(**TINY, **flags[name])
    net = (AEPoseNet(cfg, compute_dtype=torch.float64) if name == "ae_posenet"
           else imhn.create_model(cfg, compute_dtype=torch.float64))
    return net, _network, 3, lambda S: (64, 64)


def _network(m, x, bn_stats, rows):
    """Every stack's and scale's output of a network, NCHW."""
    outs = m(x.permute(0, 2, 3, 1), bn_stats=bn_stats, rows=rows)
    return [y.permute(0, 3, 1, 2) for stack in outs for y in stack]


def _conv(m, x, bn_stats, rows):
    return [m(x, bn_stats, rows)]


def _run(m, fn, x, R, group, rows, band):
    """Outputs, d(objective)/dx and the parameters' gradients (summed over
    the ranks on bands); ``band``: which outputs are this rank's band (the
    others are whole)."""
    x = x.clone().requires_grad_(True)
    stats = mesh_lib.BatchStats(group)
    ys = fn(m, x, stats, rows)
    obj = 0
    for y, r, b in zip(ys, R, band):
        if rows is not None:
            r = rows.own(r) if b else r / rows.size   # a whole output: 1/S each
        obj = obj + (y * r).sum()
    params = [] if m is None else list(m.parameters())
    grads = torch.autograd.grad(obj, [x] + params)
    pgrads = list(grads[1:])
    if rows is not None:
        pgrads = [mesh_lib.all_reduce_sum(p, group) for p in pgrads]
    return [y.detach() for y in ys], grads[0], pgrads


def run(rank: int, world: int) -> dict:
    """Every case on this rank; {case: (largest error, scale)}."""
    group = dist.group.WORLD
    rows = RowShard(group, rank, world)
    out = {}
    for k, name in enumerate(CASES + MODEL_CASES):
        g = torch.Generator().manual_seed(k)
        m, fn, cin, hrows = _case(name)
        if m is not None:
            m = m.double()
            with torch.no_grad():
                for p in m.parameters():
                    p.copy_(torch.randn(p.shape, generator=g, dtype=p.dtype) * 0.3)
        hw = hrows(world)
        H, Wd = hw if isinstance(hw, tuple) else (hw, W)
        x = torch.randn(B, cin, H, Wd, generator=g, dtype=torch.float64)
        with torch.no_grad():
            shapes = [y.shape for y in fn(m, x, {}, None)]
            band = [y.shape[2] * world == s[2] for y, s in zip(
                fn(m, rows.own(x), mesh_lib.BatchStats(group), rows), shapes)]
        R = [torch.randn(s, generator=g, dtype=torch.float64) for s in shapes]
        want_y, want_gx, want_gp = _run(m, fn, x, R, None, None, band)
        got_y, got_gx, got_gp = _run(m, fn, rows.own(x), R, group, rows, band)
        errs, scale = [], 0.0
        for gy, wy, b in zip(got_y, want_y, band):
            wy = rows.own(wy) if b else wy
            errs.append((gy - wy).abs().max())
            scale = max(scale, float(wy.abs().max()))
        errs.append((got_gx - rows.own(want_gx)).abs().max())
        errs += [(a - b).abs().max() for a, b in zip(got_gp, want_gp)]
        scale = max([scale, float(want_gx.abs().max())]
                    + [float(p.abs().max()) for p in want_gp])
        out[name] = (float(max(errs)), scale)
    return out
