"""Focal L2 multi-scale, multi-stack supervision loss.

The port of ``improved_body_parts_tpu/losses.py`` (all of it), itself a
re-design of the reference loss (models/loss_model.py:23-161):

  * NHWC tensors, as the JAX package's; GT down-scaling is an exact average
    pool (the reference's ``adaptive_avg_pool2d``, loss_model.py:52) as a
    reshape-mean.
  * mask_miss is bilinearly resized per scale then zeroed below 0.5
    (loss_model.py:55-56). ``jax.image.resize(..., "linear")`` antialiases
    when it downsamples, so the resize here is
    ``F.interpolate(..., antialias=True)``; without it a random mask differs
    by up to 0.3 (the all-ones masks of the synthetic data do not show it).
  * Channel re-weighting: person-mask channel (index BKG_START, i.e. -2)
    x multi_task_weight, keypoint channels x keypoint_task_weight
    (loss_model.py:148-149).
  * Focal factor: st = where(gt >= 0.01, s, 1-s); factor = |1-st|^gamma with
    gamma=1 in the live path (loss_model.py:151-152).
  * Stack losses weighted by nstack_weight / sum, scale losses by
    scale_weight / sum, divided by batch size (loss_model.py:37-40,156-161).

Everything is fp32: predictions and the mask are cast before the loss (a
float64 model's loss stays float64).

On a spatial mesh (``rows``, ``parallel/spatial.py``) the ground truth and
the mask are this rank's band of the rows and the loss is this band's
share: a split scale pools its band of the ground truth (the band's rows
align with every pooling window) and cuts its band of the mask resized
whole (the antialiased resize reads past a window, so the mask is gathered
first); a gathered scale takes the whole ground truth and counts 1/S on
each rank. The shares of a spatial group sum to the loss of its data
slice.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from improved_body_parts_tpu_torch.configs import (
    BKG_START, HEAT_START, NUM_LAYERS, TrainConfig,
)
from improved_body_parts_tpu_torch.parallel.spatial import RowShard, split_at
from improved_body_parts_tpu_torch.utils.device import constant


def channel_weights(multi_task_weight: float, keypoint_task_weight: float,
                    device=None, dtype=torch.float32) -> torch.Tensor:
    """Per-channel loss weight vector (50,). reference: loss_model.py:148-149."""
    w = torch.ones((NUM_LAYERS,), dtype=dtype, device=device)
    w[HEAT_START:BKG_START] *= keypoint_task_weight
    w[BKG_START] *= multi_task_weight            # channel -2: person mask
    return w


@functools.lru_cache(maxsize=64)
def _weights(values: tuple, device: torch.device,
             dtype: torch.dtype) -> torch.Tensor:
    """A constant weight vector on ``device``, made once and kept: a copy
    from the host inside the train step could not be captured in a CUDA
    graph. Callers must not write to it."""
    return constant(values, device, dtype)


@functools.lru_cache(maxsize=16)
def _channel_weights(multi_task_weight: float, keypoint_task_weight: float,
                     device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return channel_weights(multi_task_weight, keypoint_task_weight, device, dtype)


def avg_pool_to(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Exact adaptive average pool for integer-divisible sizes (NHWC)."""
    n, h, w, c = x.shape
    kh, kw = h // out_h, w // out_w
    if kh == 1 and kw == 1:
        return x
    return x.reshape(n, out_h, kh, out_w, kw, c).mean(dim=(2, 4))


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear (half-pixel) resize of NHWC ``x``, antialiased when it
    downsamples: ``jax.image.resize(..., method="linear")``."""
    n, h, w, c = x.shape
    if (h, w) == (out_h, out_w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def focal_l2(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
             gamma: float = 1.0) -> torch.Tensor:
    """Focal L2 per-element loss, summed over all but the stack axis.

    pred: (nstack, N, h, w, C); gt: (N, h, w, C); mask: (N, h, w, C) weighted.
    Returns (nstack,) sums. reference: loss_model.py:133-161.
    """
    st = torch.where(gt >= 0.01, pred, 1.0 - pred)
    factor = torch.abs(1.0 - st)
    if gamma != 1.0:
        factor = factor ** gamma
    out = torch.square(pred - gt) * factor * mask[None]
    return out.sum(dim=(1, 2, 3, 4))


def plain_l2(pred: torch.Tensor, gt: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Plain L2 variant (reference loss_model.py:102-131, loss_model_parallel.py)."""
    out = torch.square(pred - gt) * mask[None]
    return out.sum(dim=(1, 2, 3, 4))


def offset_l1_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                   nstack_weight=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """L1 loss for offset maps (reference loss_model.py:83-100; the offset
    head is unused by the live training path but kept for parity).

    pred/gt/mask: (nstack, N, h, w, 2). Returns a scalar."""
    per_stack = (torch.abs(pred - gt) * mask).sum(dim=(1, 2, 3, 4))
    nw = _weights(tuple(nstack_weight[:pred.shape[0]]), pred.device,
                  torch.float32)
    return torch.sum(per_stack * nw) / torch.sum(nw)


def multi_task_loss(preds: Sequence[Sequence[torch.Tensor]],
                    gt_heatmaps: torch.Tensor,
                    mask_miss: torch.Tensor,
                    cfg: TrainConfig = TrainConfig(),
                    use_focal: bool = True,
                    rows: Optional[RowShard] = None) -> torch.Tensor:
    """Total training loss.

    preds:       [nstack][num_scales] NHWC (N, 128/2^s, 128/2^s, 50) outputs.
    gt_heatmaps: (N, 128, 128, 50) ground truth at stride 4.
    mask_miss:   (N, 128, 128, 1) unannotated-region mask.
    Returns a scalar. reference: loss_model.py:23-40. With ``rows`` every
    input is this rank's band (a gathered scale's predictions whole) and
    the result this band's share (module docstring).
    """
    nstack = len(preds)
    num_scales = len(preds[0])
    assert len(cfg.scale_weight) >= num_scales and len(cfg.nstack_weight) >= nstack
    # smaller model variants (fewer stacks/scales) use the leading weights
    device = gt_heatmaps.device
    dt = torch.promote_types(preds[0][0].dtype, torch.float32)
    nw = _weights(tuple(cfg.nstack_weight[:nstack]), device, dt)
    sw = _weights(tuple(cfg.scale_weight[:num_scales]), device, dt)
    ch_w = _channel_weights(cfg.multi_task_weight, cfg.keypoint_task_weight,
                            device, dt)
    gt_heatmaps = gt_heatmaps.to(dt)
    mask_miss = mask_miss.to(dt)
    batch = gt_heatmaps.shape[0]
    h0 = gt_heatmaps.shape[1]
    if rows is not None:
        with torch.no_grad():
            mask_miss = rows.gather(mask_miss, dim=1)
            gt_whole = (rows.gather(gt_heatmaps, dim=1)
                        if not all(split_at(h0, s) for s in range(num_scales))
                        else None)

    total = 0
    for s in range(num_scales):
        stack_preds = torch.stack([preds[t][s].to(dt) for t in range(nstack)])
        h, w = stack_preds.shape[2], stack_preds.shape[3]
        share = 1.0
        if rows is None:
            gt = avg_pool_to(gt_heatmaps, h, w)
            mask = resize_bilinear(mask_miss, h, w)
        elif split_at(h0, s):
            gt = avg_pool_to(gt_heatmaps, h, w)
            mask = rows.own(resize_bilinear(mask_miss, h * rows.size, w), dim=1)
        else:
            gt = avg_pool_to(gt_whole, h, w)
            mask = resize_bilinear(mask_miss, h, w)
            share = 1.0 / rows.size
        mask = torch.where(mask < 0.5, 0.0, mask)       # loss_model.py:56
        mask = mask * ch_w                               # broadcast (N,h,w,50)
        if use_focal:
            per_stack = focal_l2(stack_preds, gt, mask, cfg.focal_gamma)
        else:
            per_stack = plain_l2(stack_preds, gt, mask)
        term = torch.sum(per_stack * nw) / torch.sum(nw) * sw[s]
        total = total + (term if share == 1.0 else term * share)
    return total / torch.sum(sw) / batch
