"""Plain training reference: the resident feed, the ground truth, the loss
and one SGD step, in float32 (or float64).

Frozen copies of the port's ``ops/warp.affine_warp``,
``train_lib.resident_inputs``, ``data/heatmaps_device.DeviceHeatmapper``,
``losses.multi_task_loss`` and the SGD update of
``train_lib.make_train_step``, without the CUDA-graph constants, the bands
of rows and the collectives. It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from perf_bench.reference.layout import (
    BKG_START, HEAT_START, LIMBS_CONN, NUM_LAYERS, NUM_PARTS, CanonicalConfig,
    TrainConfig,
)
from perf_bench.reference.model import Ctx, Lower, PoseNet

# the augmentation's border colour of the image (py_data_transformer.py:118-129)
BORDER_BGR = (124, 127, 127)


def affine_warp(img: torch.Tensor, inv_m, fill_value=0.0,
                out_hw=None) -> torch.Tensor:
    """Warp (..., H, W, C) by the inverse map ``inv_m`` (output -> input
    coords), bilinear, constant fill outside. ``inv_m`` is one (2, 3) numpy
    map for every leading index, the sample coordinates in fp32; or a
    (B, 2, 3) tensor of maps for images (B, H, W, C), one a sample, read
    where it lies (no trip through the host), the coordinates in its type
    (fp32, or float64 for a float64 reference). ``fill_value`` is a scalar
    or a (C,) vector (cv2's per-channel borderValue), kept on the device
    once per value; ``out_hw`` sets the output canvas (default: the
    input's)."""
    lead = img.shape[:-3]
    h, w, c = img.shape[-3:]
    oh, ow = out_hw or (h, w)
    dev = img.device
    per_sample = isinstance(inv_m, torch.Tensor)
    if per_sample:
        if len(lead) != 1 or inv_m.shape != (lead[0], 2, 3):
            raise ValueError(f"maps of shape {tuple(inv_m.shape)} for images "
                             f"{tuple(img.shape)}: want one (2, 3) map a sample")
        # (2, 3, B, 1, 1): m[i, j] broadcasts over each sample's canvas
        m = inv_m.to(dev).permute(1, 2, 0)[..., None, None]
    else:
        m = torch.as_tensor(np.asarray(inv_m, np.float32), device=dev)
    yy, xx = torch.meshgrid(torch.arange(oh, device=dev, dtype=torch.int32),
                            torch.arange(ow, device=dev, dtype=torch.int32),
                            indexing="ij")
    xx, yy = xx.to(m.dtype), yy.to(m.dtype)
    xs = m[0, 0] * xx + m[0, 1] * yy + m[0, 2]
    ys = m[1, 0] * xx + m[1, 1] * yy + m[1, 2]
    inb = (xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
    xc = torch.clamp(xs, 0, w - 1)
    yc = torch.clamp(ys, 0, h - 1)
    x0 = torch.floor(xc).long()
    y0 = torch.floor(yc).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (xc - x0)[..., None]
    fy = (yc - y0)[..., None]
    flat = img.reshape(-1, h, w, c)
    # one map for all: every image at the same cells; else each at its own
    b = (torch.arange(flat.shape[0], device=dev)[:, None, None] if per_sample
         else slice(None))
    v = (flat[b, y0, x0] * (1 - fx) * (1 - fy) + flat[b, y0, x1] * fx * (1 - fy)
         + flat[b, y1, x0] * (1 - fx) * fy + flat[b, y1, x1] * fx * fy)
    fill = np.asarray(fill_value, np.float64)
    fill = torch.as_tensor(fill, dtype=v.dtype, device=dev)
    out = torch.where(inb[..., None], v, fill)
    return out.reshape(*lead, oh, ow, c)


def resident_inputs(store: Dict[str, torch.Tensor], idx: torch.Tensor,
                    inv_m: torch.Tensor, cfg: CanonicalConfig,
                    dtype: torch.dtype = torch.float32) -> tuple:
    """Gather the records ``idx`` of the uint8 store, / 255, warp each by
    its inverse map onto the (H, W) canvas, and box-mean the masks to the
    stride grid (a mask the store lacks is ones). Returns (images (B, H, W,
    3), mask_miss (B, h, w, 1), mask_all (B, h, w))."""
    H, W, s = cfg.height, cfg.width, cfg.stride
    h4, w4 = H // s, W // s
    B = idx.shape[0]
    inv_m = inv_m.to(dtype)

    def gather(key):
        return store[key].index_select(0, idx).to(dtype) / 255.0

    def mask(key, fill):
        if key not in store:
            return torch.ones((B, h4, w4), dtype=dtype, device=idx.device)
        m = affine_warp(gather(key)[..., None], inv_m, fill_value=fill,
                        out_hw=(H, W))[..., 0]
        return m.reshape(B, h4, s, w4, s).mean(dim=(2, 4))

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    border = np.asarray(BORDER_BGR, np_dtype) / np_dtype(255)
    imgs = affine_warp(gather("images"), inv_m, fill_value=border,
                       out_hw=(H, W))
    return imgs, mask("mask_miss", 1.0)[..., None], mask("mask_all", 0.0)


def erode3_device(mask: torch.Tensor) -> torch.Tensor:
    """3×3 min-erosion with edge padding of (..., h, w) masks (host oracle:
    heatmaps.erode3)."""
    h, w = mask.shape[-2:]
    lead = mask.shape[:-2]
    p = F.pad(mask.reshape(-1, 1, h, w), (1, 1, 1, 1), mode="replicate")
    out = mask.reshape(-1, 1, h, w)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = torch.minimum(out, p[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return out.reshape(*lead, h, w)



class Heatmapper:
    """Ground-truth maps from joints on the device (the port's
    ``DeviceHeatmapper``, its constants made at each call)."""

    def __init__(self, config: CanonicalConfig = CanonicalConfig()):
        aug = config.aug
        self.stride = float(config.stride)
        self.h = config.height // config.stride
        self.w = config.width // config.stride
        self.double_sigma2 = 2.0 * aug.sigma * aug.sigma
        self.paf_sigma = aug.paf_sigma
        self.limb_thre = aug.limb_gaussian_thre
        self.paf_pad = float(config.paf_thre)
        self.gaussian_size = math.ceil(
            math.sqrt(-self.double_sigma2 * math.log(aug.keypoint_gaussian_thre))
            / config.stride) * 2
        self.grid_x = np.arange(self.w, dtype=np.float32) * self.stride \
            + self.stride / 2 - 0.5
        self.grid_y = np.arange(self.h, dtype=np.float32) * self.stride \
            + self.stride / 2 - 0.5
        self.limbs_from = np.asarray([fr for fr, _ in LIMBS_CONN])
        self.limbs_to = np.asarray([to for _, to in LIMBS_CONN])

    def constants(self, dev: torch.device, dt: torch.dtype) -> tuple:
        return (torch.as_tensor(self.grid_x, device=dev).to(dt),
                torch.as_tensor(self.grid_y, device=dev).to(dt),
                torch.arange(self.w, dtype=dt, device=dev),
                torch.arange(self.h, dtype=dt, device=dev),
                torch.as_tensor(self.limbs_from, device=dev),
                torch.as_tensor(self.limbs_to, device=dev))

    # ------------------------------------------------------------------
    def _person_kp(self, pts, vis, gx, gy, ix, iy):
        """(B,18,2) pts + (B,18) bool -> (B,18,h,w) windowed gaussians."""
        half = self.gaussian_size // 2
        cx = torch.round(pts[..., 0] / self.stride)[..., None]     # (B,18,1)
        cy = torch.round(pts[..., 1] / self.stride)[..., None]
        win_x = (ix >= torch.clamp(cx - half, min=0)) & (ix <= cx + half)
        win_y = (iy >= torch.clamp(cy - half, min=0)) & (iy <= cy + half)
        ex = torch.exp(-torch.square(gx - pts[..., 0:1]) / self.double_sigma2)
        ey = torch.exp(-torch.square(gy - pts[..., 1:2]) / self.double_sigma2)
        g = (ey * win_y)[..., :, None] * (ex * win_x)[..., None, :]
        return g * vis[..., None, None]

    def _person_limbs(self, pts, vis, X, Y, ix, iy, limbs_from, limbs_to):
        """(B,18,2)+(B,18) -> ((B,30,h,w) floored gaussians, (B,30,h,w) window)."""
        p1 = pts[:, limbs_from]                                # (B,30,2)
        p2 = pts[:, limbs_to]
        valid = vis[:, limbs_from] & vis[:, limbs_to]
        x1, y1 = p1[..., 0], p1[..., 1]
        x2, y2 = p2[..., 0], p2[..., 1]
        dx, dy = x2 - x1, y2 - y1
        dnorm2 = dx * dx + dy * dy
        valid = valid & (dnorm2 > 0)
        norm = torch.sqrt(dnorm2)

        # bbox window in grid cells; mins clamped to 0, maxes unclamped
        # (an all-negative bbox yields an empty window, = the host's skip)
        min_sx = torch.clamp(torch.round(
            (torch.minimum(x1, x2) - self.paf_pad) / self.stride), min=0)
        min_sy = torch.clamp(torch.round(
            (torch.minimum(y1, y2) - self.paf_pad) / self.stride), min=0)
        max_sx = torch.round((torch.maximum(x1, x2) + self.paf_pad) / self.stride)
        max_sy = torch.round((torch.maximum(y1, y2) + self.paf_pad) / self.stride)
        win = (((ix >= min_sx[..., None]) & (ix <= max_sx[..., None]))[..., None, :]
               & ((iy >= min_sy[..., None]) & (iy <= max_sy[..., None]))[..., :, None]
               & valid[..., None, None])

        e = (..., None, None)
        dist = torch.abs(dx[e] * (y1[e] - Y) - (x1[e] - X) * dy[e]) \
            / (norm[e] + 1e-6)
        g = torch.exp(-torch.square(dist) / (2 * self.paf_sigma ** 2))
        g = torch.where(g <= self.limb_thre, 0.01, g)
        return torch.where(win, g, 0.0), win.to(g.dtype)

    # ------------------------------------------------------------------
    def render(self, joints: torch.Tensor,
               mask_all: torch.Tensor | None = None,
               rows: tuple | None = None) -> torch.Tensor:
        """(B,P,18,3) joints (vis code 2/3 = absent; padded slots use 2) +
        optional (B,h,w) mask_all -> (B,h,w,50) float32 (float64 for float64
        joints), == the host oracle for each batch element. ``rows`` (lo,
        hi) renders only those rows of the maps, (B, hi - lo, w, 50), equal
        to the same rows of the whole render (a spatial mesh's band);
        ``mask_all`` stays whole, for the erosion's edge rows."""
        dt = torch.promote_types(joints.dtype, torch.float32)
        joints = joints.to(dt)
        dev = joints.device
        B = joints.shape[0]
        gx, gy, ix, iy, limbs_from, limbs_to = self.constants(dev, dt)
        lo, hi = rows or (0, self.h)
        if rows is not None:
            gy, iy = gy[lo:hi], iy[lo:hi]
        X, Y = gx, gy[:, None]                                  # (w,), (h, 1)
        n_limbs = len(self.limbs_from)
        h = hi - lo
        kp = torch.zeros((B, NUM_PARTS, h, self.w), dtype=dt, device=dev)
        acc = torch.zeros((B, n_limbs, h, self.w), dtype=dt, device=dev)
        cnt = torch.zeros((B, n_limbs, h, self.w), dtype=dt, device=dev)
        for p in range(joints.shape[1]):
            pts, vis = joints[:, p, :, :2], joints[:, p, :, 2] < 2
            kp = torch.maximum(kp, self._person_kp(pts, vis, gx, gy, ix, iy))
            g, win = self._person_limbs(pts, vis, X, Y, ix, iy, limbs_from,
                                        limbs_to)
            acc = acc + g
            cnt = cnt + win

        limbs = torch.where(cnt > 0, acc / torch.clamp(cnt, min=1.0), 0.0)
        if mask_all is None:
            bkg = torch.zeros((B, h, self.w), dtype=dt, device=dev)
        else:
            bkg = erode3_device(mask_all.to(dt))[:, lo:hi]
        hm = torch.cat([limbs, kp, bkg[:, None], kp.amax(dim=1, keepdim=True)],
                       dim=1)
        assert hm.shape[1] == BKG_START + 2 and HEAT_START == limbs.shape[1]
        return torch.clamp(hm, 0.0, 1.0).permute(0, 2, 3, 1)



def channel_weights(multi_task_weight: float, keypoint_task_weight: float,
                    device=None, dtype=torch.float32) -> torch.Tensor:
    """Per-channel loss weight vector (50,). reference: loss_model.py:148-149."""
    w = torch.ones((NUM_LAYERS,), dtype=dtype, device=device)
    w[HEAT_START:BKG_START] *= keypoint_task_weight
    w[BKG_START] *= multi_task_weight            # channel -2: person mask
    return w

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



def multi_task_loss(preds, gt_heatmaps: torch.Tensor, mask_miss: torch.Tensor,
                    cfg: TrainConfig = TrainConfig()) -> torch.Tensor:
    """The focal-L2 loss over every stack and scale (loss_model.py:23-40):
    preds [nstack][num_scales] NHWC, gt (N, 128, 128, 50), mask_miss (N,
    128, 128, 1); the mean over the batch."""
    nstack, num_scales = len(preds), len(preds[0])
    device = gt_heatmaps.device
    dt = torch.promote_types(preds[0][0].dtype, torch.float32)
    nw = torch.as_tensor(cfg.nstack_weight[:nstack], dtype=dt, device=device)
    sw = torch.as_tensor(cfg.scale_weight[:num_scales], dtype=dt, device=device)
    ch_w = channel_weights(cfg.multi_task_weight, cfg.keypoint_task_weight,
                           device, dt)
    gt_heatmaps = gt_heatmaps.to(dt)
    mask_miss = mask_miss.to(dt)
    batch = gt_heatmaps.shape[0]
    total = 0
    for s in range(num_scales):
        stack_preds = torch.stack([preds[t][s].to(dt) for t in range(nstack)])
        h, w = stack_preds.shape[2], stack_preds.shape[3]
        gt = avg_pool_to(gt_heatmaps, h, w)
        mask = resize_bilinear(mask_miss, h, w)
        mask = torch.where(mask < 0.5, 0.0, mask)
        mask = mask * ch_w
        per_stack = focal_l2(stack_preds, gt, mask, cfg.focal_gamma)
        total = total + torch.sum(per_stack * nw) / torch.sum(nw) * sw[s]
    return total / torch.sum(sw) / batch


@torch.no_grad()
def forward_stem(model: PoseNet, store: Dict[str, torch.Tensor],
                 idx: torch.Tensor, inv_m: torch.Tensor, cfg: CanonicalConfig,
                 lower: Lower = None) -> torch.Tensor:
    """The train-mode stem's output (``pre``, (B, C, H/4, W/4)) on the
    records ``idx``, rounded by ``lower``: what a train step's forward
    computes first."""
    dtype = next(model.parameters()).dtype
    imgs, _, _ = resident_inputs(store, idx, inv_m, cfg, dtype)
    return model.pre.run(Ctx({}, lower), imgs.permute(0, 3, 1, 2))


def train_step(model: PoseNet, momentum: Dict[str, torch.Tensor],
               store: Dict[str, torch.Tensor], idx: torch.Tensor,
               inv_m: torch.Tensor, joints: torch.Tensor, lr: float,
               cfg: CanonicalConfig, lower: Lower = None,
               jitter: float = 0.0) -> dict:
    """One step of the resident feed in the model's type, in place: the
    feed, train-mode BN over the batch, the loss, the gradients, then SGD
    with momentum 0.9 and weight decay added to every gradient before the
    trace (``p <- p - lr * (g + wd * p + 0.9 * m)``). No clipping and no
    abnormal-loss drop: a sound run never reaches the threshold. ``jitter``
    scales the warped images by (1 + jitter). Returns the loss, the
    gradients by parameter name, and the stem's output (as
    ``forward_stem``)."""
    tcfg = cfg.train
    dtype = next(model.parameters()).dtype
    imgs, mask_miss, mask_all = resident_inputs(store, idx, inv_m, cfg, dtype)
    if jitter:
        imgs = imgs * (1.0 + jitter)
    heat = Heatmapper(cfg).render(joints.to(dtype), mask_all)
    ctx = Ctx({}, lower)
    preds = model.run(imgs, ctx)
    loss = multi_task_loss(preds, heat, mask_miss, tcfg)
    names = [k for k, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        for k, p, g in zip(names, params, grads):
            u = g + tcfg.weight_decay * p + tcfg.momentum * momentum[k]
            momentum[k].copy_(u)
            p.sub_(lr * u)
    return {"loss": loss.detach(), "grads": dict(zip(names, grads)),
            "stem": ctx.stem.detach()}
