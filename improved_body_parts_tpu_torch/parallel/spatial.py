"""The ``spatial`` mesh axis: the image height sharded over ranks.

The port of what XLA's SPMD partitioner does for the JAX package when the
images of a train step are sharded ``P("data", "spatial")``
(``improved_body_parts_tpu/parallel/mesh.py``, ``__graft_entry__.py``): each
rank of a spatial group holds a contiguous band of rows of every image of
its data slice, and the network runs on its band. What crosses the bands is
written here by hand, each a ``torch.autograd.Function`` whose backward
sends the gradient back the way the values came:

  * ``RowShard.halo``: this band plus ``top`` rows from the band above and
    ``bottom`` rows from the band below (zeros at the image's edges, which
    is the conv's own zero padding). Its backward adds the halo's gradient
    to the neighbours' rows. ``conv2d`` runs every conv with k > 1 (the
    7×7 stride-2 stem, the 3×3 and the dilated convs) on the halo'd band
    with no row padding;
  * ``RowShard.gather``: every band of a tensor, stacked in row order, on
    every rank, for the levels too short to split (a level whose band
    cannot be halved, or is narrower than a conv's halo). The gathered
    level runs replicated over the spatial group (``RowShard.full``); the
    backward gives each rank its rows of the gradient summed over ranks;
  * ``RowShard.sum``: a sum over the spatial group (the SE layer's mean;
    ``parallel/mesh.all_reduce_sum``).

Every exchange is an all-reduce over the spatial group of a buffer with a
slot a rank (zeros but this rank's slot), in fp32 (float64 for a float64
model; the cast is exact both ways), so gloo and NCCL run the same code,
gloo on the card included (gloo takes no point-to-point on CUDA tensors).
A band's rows are a contiguous ``narrow`` of NCHW (dim 2); the train
step's NHWC inputs take dim 1.

Which levels are split is decided by the rows alone: with a band of ``h0``
rows at stride 4, scale s (stride 4·2^s) is split when 2^s divides h0
(``split_at``), else gathered; the hourglass (``models/imhn.py``) and the
loss (``losses.multi_task_loss``) read the same rule. A gathered scale's
loss term counts 1/S on each rank, and its train-mode BatchNorm statistics
are taken over the data group only, so no level counts S times.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from improved_body_parts_tpu_torch.parallel.mesh import all_reduce_sum

# exchanges made since the last ``reset_counts`` (a remat'd hourglass makes
# its exchanges again in the backward pass, and they count again). Counted
# where a step calls them: a CUDA graph's capture records one step's and
# adds them once a replay (``train_graph.GraphedStep``)
counts = {"halo": 0, "gather": 0, "sum": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _wide(dt: torch.dtype) -> torch.dtype:
    return torch.promote_types(dt, torch.float32)


@torch.no_grad()
def _all_gather(x: torch.Tensor, rows: "RowShard") -> torch.Tensor:
    """(S, *x.shape): every rank's ``x`` (same shape on every rank) in
    rank order, by one all-reduce of a buffer with a slot a rank."""
    buf = x.new_zeros((rows.size, *x.shape), dtype=_wide(x.dtype))
    buf[rows.index].copy_(x)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=rows.group)
    return buf.to(x.dtype)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows, top: int, bottom: int, dim: int):
        ctx.rows, ctx.top, ctx.bottom, ctx.dim = rows, top, bottom, dim
        h, s, n = x.shape[dim], rows.index, rows.size
        # my first ``bottom`` rows are the bottom halo of the band above;
        # my last ``top`` rows the top halo of the band below
        got = _all_gather(torch.cat([x.narrow(dim, 0, bottom),
                                     x.narrow(dim, h - top, top)], dim), rows)
        above = (got[s - 1].narrow(dim, bottom, top) if s > 0 else
                 x.new_zeros(_rows_shape(x, dim, top)))
        below = (got[s + 1].narrow(dim, 0, bottom) if s < n - 1 else
                 x.new_zeros(_rows_shape(x, dim, bottom)))
        return torch.cat([above, x, below], dim)

    @staticmethod
    def backward(ctx, g):
        rows, top, bottom, dim = ctx.rows, ctx.top, ctx.bottom, ctx.dim
        s, n = rows.index, rows.size
        h = g.shape[dim] - top - bottom
        # the top halo's gradient belongs to the band above's last rows,
        # the bottom halo's to the band below's first rows
        got = _all_gather(torch.cat([g.narrow(dim, 0, top),
                                     g.narrow(dim, top + h, bottom)], dim), rows)
        gx = g.narrow(dim, top, h).clone()
        if s < n - 1 and top:
            gx.narrow(dim, h - top, top).add_(got[s + 1].narrow(dim, 0, top))
        if s > 0 and bottom:
            gx.narrow(dim, 0, bottom).add_(got[s - 1].narrow(dim, top, bottom))
        return gx, None, None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows, dim: int):
        ctx.rows, ctx.dim, ctx.h = rows, dim, x.shape[dim]
        return torch.cat(_all_gather(x, rows).unbind(0), dim)

    @staticmethod
    def backward(ctx, g):
        rows = ctx.rows
        total = g.to(_wide(g.dtype)).contiguous()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=rows.group)
        return (total.narrow(ctx.dim, rows.index * ctx.h, ctx.h).to(g.dtype),
                None, None)


def _rows_shape(x: torch.Tensor, dim: int, n: int) -> tuple:
    shape = list(x.shape)
    shape[dim] = n
    return tuple(shape)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's place on the spatial axis: its ``index`` of ``size``
    bands, the spatial ``group`` the bands are exchanged in, and the data
    ``group`` of its spatial index (None on one data slice), over which a
    gathered level takes its BatchNorm statistics. ``replicated``: the
    tensors this context goes with are whole (a gathered level), not a
    band."""
    group: object
    index: int
    size: int
    data_group: Optional[object] = None
    replicated: bool = False

    @classmethod
    def of(cls, mesh) -> "RowShard":
        """The spatial context of a ``parallel/mesh.Mesh`` with a spatial
        axis."""
        if mesh.spatial < 2:
            raise ValueError("the mesh has no spatial axis")
        return cls(mesh.spatial_group, mesh.spatial_index, mesh.spatial,
                   mesh.data_group)

    @property
    def full(self) -> "RowShard":
        """The context of a gathered (replicated) level."""
        return dataclasses.replace(self, replicated=True)

    def range(self, n: int) -> Tuple[int, int]:
        """This band's [lo, hi) of ``n`` rows."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split into {self.size} bands")
        per = n // self.size
        return self.index * per, (self.index + 1) * per

    def own(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """This band's rows of a whole tensor (local; the backward puts the
        gradient in this band's rows and zeros elsewhere)."""
        lo, hi = self.range(x.shape[dim])
        return x.narrow(dim, lo, hi - lo)

    def halo(self, x: torch.Tensor, top: int, bottom: int,
             dim: int = 2) -> torch.Tensor:
        """The band with ``top`` rows of the band above and ``bottom`` of
        the band below (zeros past the image's edges)."""
        if top > x.shape[dim] or bottom > x.shape[dim]:
            raise ValueError(f"a halo of ({top}, {bottom}) rows is wider than "
                             f"a band of {x.shape[dim]}")
        counts["halo"] += 1
        return _Halo.apply(x, self, top, bottom, dim)

    def gather(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """The whole tensor (every band, in row order) on every rank."""
        counts["gather"] += 1
        return _Gather.apply(x, self, dim)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the spatial group (differentiable)."""
        counts["sum"] += 1
        return all_reduce_sum(x, self.group)


def split_at(h0: int, s: int) -> bool:
    """Whether scale ``s`` (stride 4·2^s) is split into bands, given the
    band of ``h0`` rows at stride 4: each hourglass level halves the band,
    and a band with an odd number of rows cannot be halved locally."""
    return h0 % (1 << s) == 0


def scale_rows(rows: Optional[RowShard], h0: int, s: int) -> Optional[RowShard]:
    """The context of scale ``s``: ``rows``, or its replicated form for a
    gathered scale (None without a spatial axis)."""
    if rows is None or rows.replicated or split_at(h0, s):
        return rows
    return rows.full


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias, stride, padding,
           dilation, rows: Optional[RowShard]) -> torch.Tensor:
    """``F.conv2d`` (tuples of stride, padding, dilation) on a band: the
    output band of the same conv on the whole image. A conv whose receptive
    field crosses rows runs on the halo'd band without row padding: output
    row o of stride st reads input rows st·o - p .. st·o - p + K - 1 (K =
    d(k-1)+1), so a band starting at a multiple of st needs p rows from
    above and K - st - p from below (3 and 2 for the 7×7 stride-2 stem).
    A band narrower than its halo is gathered, convolved whole and cut."""
    if rows is None or rows.replicated:
        return F.conv2d(x, weight, bias, stride, padding, dilation)
    st, p, d = stride[0], padding[0], dilation[0]
    ext = d * (weight.shape[2] - 1) + 1
    top, bottom = p, max(ext - st - p, 0)
    h = x.shape[2]
    if top == bottom == 0 and h % st == 0:
        return F.conv2d(x, weight, bias, stride, padding, dilation)
    if max(top, bottom) > h or h % st:
        return rows.own(F.conv2d(rows.gather(x), weight, bias, stride, padding,
                                 dilation))
    return F.conv2d(rows.halo(x, top, bottom), weight, bias, stride,
                    (0, padding[1]), dilation)
