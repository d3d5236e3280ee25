"""Inference on the card: images -> skeletons, with flip, multi-scale and
rotation TTA.

Port of ``improved_body_parts_tpu/infer/predict.py``: [orig, h-flip] run as
one batch through the model, the flip pair is averaged with the channel
permutation, peaks and limbs are found on the stride-4 maps, and everything
the host needs comes back as ONE packed float32 buffer per image (same
layout as the JAX package's), which the host groups into people with the
port's ``ops.group`` / ``ops.group_cpp``. ``infer.serving.PipelinedServer``
drives this ``Predictor``.

Multi-scale and rotation TTA (``scales``/``angles``) follow the JAX
package's device programs (``_device_fn_tta``/``_device_fn_batch_tta``):
each scale resizes (cv2-cubic) and bucket-pads the batch, each angle rotates
it, the flip pair runs, the maps are rotated back about the stride-map
centre, cropped to the scaled content and resized to the base maps, and the
variants are averaged before one post-processing pass. ``mesh`` (sharded
serving) raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from improved_body_parts_tpu_torch.configs import (
    CanonicalConfig, FLIP_CHANNEL_ORD, NUM_LAYERS, NUM_LIMBS, NUM_PARTS,
    PAF_LAYERS,
)
from improved_body_parts_tpu_torch.ops import group, group_cpp
from improved_body_parts_tpu_torch.ops.limbs import (
    Connections, connections_to_list, score_connections, select_connections,
)
from improved_body_parts_tpu_torch.ops.peaks import PeakTable, find_peaks
from improved_body_parts_tpu_torch.ops.warp import (
    affine_warp, resize_cubic_cv2, rotation_matrix,
)


# ---------------------------------------------------------------------------
# result packing: everything the host needs, in one float32 row per image
# ---------------------------------------------------------------------------

def packed_size(P: int) -> int:
    return NUM_PARTS * P * 4 + NUM_LIMBS * P * 5 + NUM_PARTS


def pack_results(peaks: PeakTable, conns: Connections) -> torch.Tensor:
    """Batched peak + connection tables -> (B, packed_size) float32."""
    B = peaks.score.shape[0]
    parts = [
        peaks.xy, peaks.score, peaks.valid, conns.src_slot, conns.dst_slot,
        conns.score, conns.limb_len, conns.valid, peaks.n_raw,
    ]
    return torch.cat([p.to(torch.float32).reshape(B, -1) for p in parts], dim=1)


def unpack_results(buf: np.ndarray, P: int):
    """Inverse of ``pack_results`` for ONE image, on host numpy. Returns
    (peaks, conns) as numpy ``PeakTable`` / ``Connections``."""
    o = 0

    def take(n, shape):
        nonlocal o
        out = buf[o:o + n].reshape(shape)
        o += n
        return out

    xy = take(NUM_PARTS * P * 2, (NUM_PARTS, P, 2))
    score = take(NUM_PARTS * P, (NUM_PARTS, P))
    valid = take(NUM_PARTS * P, (NUM_PARTS, P)) > 0.5
    src = take(NUM_LIMBS * P, (NUM_LIMBS, P)).astype(np.int32)
    dst = take(NUM_LIMBS * P, (NUM_LIMBS, P)).astype(np.int32)
    cscore = take(NUM_LIMBS * P, (NUM_LIMBS, P))
    clen = take(NUM_LIMBS * P, (NUM_LIMBS, P))
    cvalid = take(NUM_LIMBS * P, (NUM_LIMBS, P)) > 0.5
    n_raw = take(NUM_PARTS, (NUM_PARTS,)).astype(np.int32)
    peaks = PeakTable(xy=xy, score=score, valid=valid, grid_yx=None,
                      n_raw=n_raw)
    conns = Connections(src_slot=src, dst_slot=dst, score=cscore,
                        limb_len=clen, valid=cvalid)
    return peaks, conns


# ---------------------------------------------------------------------------
# host-side preprocessing
# ---------------------------------------------------------------------------

def _cv2():
    """OpenCV, imported only when a frame has to be resized."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("this frame has to be resized, which needs OpenCV "
                           "(cv2), and cv2 is not installed; send frames whose "
                           "size needs no resize") from e
    return cv2


def pad_image_to_bucket(img: np.ndarray, bucket: int = 64,
                        pad_value: int = 128,
                        max_hw: Tuple[int, int] = (2600, 3800)):
    """Pad bottom/right with ``pad_value`` up to the next multiple of
    ``bucket`` (images beyond ``max_hw`` are first scaled down). Returns
    (padded uint8 image, (orig_h, orig_w)). reference: utils/util.py:44-65."""
    h, w = img.shape[:2]
    if h > max_hw[0] or w > max_hw[1]:
        scale = min(max_hw[0] / h, max_hw[1] / w)
        cv2 = _cv2()
        img = cv2.resize(img, (0, 0), fx=scale, fy=scale,
                         interpolation=cv2.INTER_CUBIC)
        h, w = img.shape[:2]
    ph = -(-h // bucket) * bucket
    pw = -(-w // bucket) * bucket
    out = np.full((ph, pw, 3), pad_value, dtype=np.uint8)
    out[:h, :w] = img
    return out, (h, w)


def center_pad_to_bucket(img: np.ndarray, bucket: int = 64,
                         pad_value: int = 128):
    """Centered bucket padding (reference utils/util.py:68-100
    ``center_pad``): the pad is split between both sides. Returns (padded
    uint8, pad [up, left, down, right], (orig_h, orig_w))."""
    h, w = img.shape[:2]
    ph = -(-h // bucket) * bucket
    pw = -(-w // bucket) * bucket
    top = (ph - h) // 2
    left = (pw - w) // 2
    out = np.full((ph, pw, 3), pad_value, dtype=np.uint8)
    out[top:top + h, left:left + w] = img
    return out, [top, left, ph - h - top, pw - w - left], (h, w)


def gaussian_blur(maps: torch.Tensor, kernel_size: int = 5,
                  sigma: float = 1.0) -> torch.Tensor:
    """Separable gaussian smoothing of (..., H, W) with reflect padding
    (reference utils/util.py:103-174 ``GaussianSmoothing``; optional
    smoothing before NMS, not on the serving path)."""
    half = (kernel_size - 1) // 2
    xs = torch.arange(kernel_size, dtype=torch.float32, device=maps.device) - half
    k = torch.exp(-0.5 * torch.square(xs / sigma))
    k = k / torch.sum(k)
    lead = maps.shape[:-2]
    h, w = maps.shape[-2:]
    flat = maps.reshape(-1, 1, h, w)
    padded = F.pad(flat, (half, half, half, half), mode="reflect")[:, 0]
    rows = sum(padded[:, :, i:i + w] * k[i] for i in range(kernel_size))
    cols = sum(rows[:, i:i + h, :] * k[i] for i in range(kernel_size))
    return cols.reshape(*lead, h, w)


def _tta_key(scales, angles) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    return (tuple(scales) if scales is not None else (1.0,)), tuple(angles)


class Predictor:
    """Predictor over a port ``PoseNet`` living on ``device``.

    ``refine`` is a ``find_peaks`` refinement ("bicubic", "centroid",
    "none", or "bicubicN": bicubic on an N-times upsample grid).
    ``suppress_pad_peaks`` invalidates peaks in the bucket/letterbox pad
    band (the reference ORIGINAL path, parse_skeletons.py:272-281); False
    keeps them, as the reference refactor path does. ``fused_peaks``
    selects the fused peak kernel in post-processing."""

    def __init__(self, model: torch.nn.Module,
                 config: CanonicalConfig = CanonicalConfig(), *,
                 device: torch.device, refine: str = "bicubic",
                 suppress_pad_peaks: bool = True,
                 fused_peaks: Optional[bool] = False):
        self.model = model
        self.config = config
        self.device = torch.device(device)
        self.refine = refine
        self.suppress_pad_peaks = suppress_pad_peaks
        self.fused_peaks = bool(fused_peaks)
        self._flip_ord = torch.as_tensor(FLIP_CHANNEL_ORD, dtype=torch.long,
                                         device=self.device)

    # -- device stages -------------------------------------------------------
    def _postprocess(self, avg: torch.Tensor, img_h: torch.Tensor,
                     content_hw: Optional[torch.Tensor] = None):
        """avg (B, h/4, w/4, 50) averaged maps -> (packed (B, n), paf,
        heat). ``content_hw`` (B, 2) float [h, w] valid-content extents."""
        cfg, icfg = self.config, self.config.infer
        if not self.suppress_pad_peaks:
            content_hw = None
        refine, refine_up = self.refine, None
        if refine.startswith("bicubic") and refine != "bicubic":
            refine_up = int(refine[len("bicubic"):])
            refine = "bicubic"
        paf = avg[..., :PAF_LAYERS]
        heat = avg[..., PAF_LAYERS:NUM_LAYERS]
        peaks = find_peaks(heat[..., :NUM_PARTS], thre=icfg.thre1,
                           max_peaks=icfg.max_peaks, stride=cfg.stride,
                           refine=refine, content_hw=content_hw,
                           refine_upsample=refine_up, fused=self.fused_peaks)
        cand = score_connections(
            paf, peaks.xy, peaks.score, peaks.valid, img_h,
            mid_num=icfg.mid_num, stride=cfg.stride, thre2=icfg.thre2,
            connect_ration=icfg.connect_ration)
        conns = select_connections(cand, peaks.valid)
        return pack_results(peaks, conns), paf, heat

    def _flip_avg_maps(self, imgs: torch.Tensor) -> torch.Tensor:
        """imgs (B, h, w, 3) float in [0, 1] -> (B, h/4, w/4, 50) flip-avg."""
        both = torch.cat([imgs, imgs.flip(2)], dim=0)
        out = self.model.predict_maps(both)                # (2B, h/4, w/4, 50)
        B = imgs.shape[0]
        orig, flip = out[:B], out[B:]
        flip = flip.flip(2)[..., self._flip_ord]
        return (orig + flip) * 0.5

    def _tta_maps(self, imgs: torch.Tensor, scales: Tuple[float, ...],
                  angles: Tuple[float, ...]) -> torch.Tensor:
        """imgs (B, h, w, 3) float in [0, 1] -> (B, h/4, w/4, 50): the flip
        average of every scale x angle variant, mapped back to the base
        stride grid and averaged (JAX ``_device_fn_tta`` and
        ``_device_fn_batch_tta``, predict.py:263-387)."""
        B, h, w = imgs.shape[:3]
        bucket = self.config.infer.max_downsample
        pad_val = self.config.infer.pad_value / 255.0
        stride = self.config.stride
        base_h4, base_w4 = h // stride, w // stride
        acc = torch.zeros((B, base_h4, base_w4, NUM_LAYERS), dtype=torch.float32,
                          device=imgs.device)
        for s in scales:
            sh, sw = int(round(h * s)), int(round(w * s))
            ph = -(-sh // bucket) * bucket
            pw = -(-sw // bucket) * bucket
            imgs_s = imgs if s == 1.0 else resize_cubic_cv2(imgs, sh, sw)
            imgs_p = torch.full((B, ph, pw, 3), pad_val, dtype=torch.float32,
                                device=imgs.device)
            imgs_p[:, :sh, :sw] = imgs_s
            for ang in angles:
                if ang != 0.0:
                    inv = rotation_matrix((pw / 2.0, ph / 2.0), -ang)
                    x = affine_warp(imgs_p, inv, fill_value=pad_val)
                else:
                    x = imgs_p
                avg = self._flip_avg_maps(x)
                if ang != 0.0:
                    # the image-space rotation centre (pw/2, ph/2) on the
                    # stride grid, by the half-pixel convention
                    cx_s = (pw / 2.0 + 0.5) / stride - 0.5
                    cy_s = (ph / 2.0 + 0.5) / stride - 0.5
                    avg = affine_warp(avg, rotation_matrix((cx_s, cy_s), ang))
                vh = max(int(round(sh / stride)), 1)
                vw = max(int(round(sw / stride)), 1)
                acc = acc + resize_cubic_cv2(avg[:, :vh, :vw], base_h4, base_w4)
        return acc / float(len(scales) * len(angles))

    def _maps(self, imgs_u8: np.ndarray, scales=(1.0,), angles=(0.0,)):
        """(B, H, W, 3) uint8 -> (B, H/4, W/4, 50) averaged maps on the card."""
        imgs = torch.from_numpy(np.ascontiguousarray(imgs_u8)).to(
            self.device, non_blocking=True)
        imgs = imgs.to(torch.float32) / 255.0
        if tuple(scales) == (1.0,) and tuple(angles) == (0.0,):
            return self._flip_avg_maps(imgs)
        return self._tta_maps(imgs, tuple(scales), tuple(angles))

    def _run(self, imgs_u8: np.ndarray, img_hs: np.ndarray,
             content_hws: np.ndarray, scales=(1.0,), angles=(0.0,)):
        """(B, H, W, 3) uint8 -> (packed (B, n) on the device, paf, heat)."""
        with torch.inference_mode():
            avg = self._maps(imgs_u8, scales, angles)
            return self._postprocess(
                avg, torch.as_tensor(img_hs, dtype=torch.float32, device=self.device),
                torch.as_tensor(content_hws, dtype=torch.float32, device=self.device))

    # -- host API ------------------------------------------------------------
    def _group(self, peaks_np: PeakTable, conns_np: Connections,
               use_cpp: Optional[bool]):
        P = self.config.infer.max_peaks
        connected = connections_to_list(conns_np, P, self.config.limbs_conn)
        cands = group.build_joint_candidates(
            peaks_np.xy, peaks_np.score, peaks_np.valid)
        if use_cpp is None or use_cpp:
            # numpy only when the C++ library is UNAVAILABLE (no compiler)
            if group_cpp.is_available():
                return group_cpp.find_humans(connected, cands, self.config.infer)
            if use_cpp:
                raise RuntimeError("C++ grouping requested but unavailable")
        return group.find_humans(connected, cands, self.config.infer)

    def _pad(self, img: np.ndarray):
        icfg = self.config.infer
        return pad_image_to_bucket(img, bucket=icfg.max_downsample,
                                   pad_value=icfg.pad_value,
                                   max_hw=(icfg.img_max_h, icfg.img_max_w))

    def predict_maps(self, img: np.ndarray, img_h_override: Optional[float] = None,
                     content_hw_override: Optional[Tuple[float, float]] = None):
        """One BGR uint8 image (any size), single scale -> (packed (n,),
        paf, heat, (orig_h, orig_w)), tensors on the card. ``img_h_override``
        replaces the limb-length prior's height and ``content_hw_override``
        the pad-suppression extent (the letterbox path)."""
        return self.predict_maps_tta(img, (1.0,), (0.0,), img_h_override,
                                     content_hw_override)

    def predict_maps_tta(self, img: np.ndarray,
                         scales: Tuple[float, ...] = (0.5, 1.0, 1.5, 2.0),
                         angles: Tuple[float, ...] = (0.0,),
                         img_h_override: Optional[float] = None,
                         content_hw_override: Optional[Tuple[float, float]] = None):
        """Multi-scale / rotation TTA of one image. ``scales`` multiply the
        padded input size (the reference scales by boxsize/img_h *
        scale_search; pass those factors). Returns (packed, paf, heat,
        (orig_h, orig_w))."""
        padded, (orig_h, orig_w) = self._pad(img)
        content = content_hw_override or (orig_h, orig_w)
        packed, paf, heat = self._run(
            padded[None], np.float32([img_h_override or orig_h]),
            np.float32([content]), *_tta_key(scales, angles))
        return packed[0], paf[0], heat[0], (orig_h, orig_w)

    def predict_avg_maps(self, img: np.ndarray):
        """One BGR uint8 image (any size) -> (flip-averaged stride-4 maps
        as numpy (ph/4, pw/4, 50), (orig_h, orig_w)); no post-processing."""
        padded, orig_hw = self._pad(img)
        with torch.inference_mode():
            maps = self._maps(padded[None])[0]
        return maps.cpu().numpy(), orig_hw

    def letterbox(self, img: np.ndarray) -> Tuple[np.ndarray, float]:
        """Scale the longer side to ``boxsize`` and pad to a square canvas.
        Returns (boxsize x boxsize uint8, scale applied). A frame whose
        longer side already is ``boxsize`` is not resized (and needs no cv2)."""
        size = self.config.infer.boxsize
        h, w = img.shape[:2]
        scale = min(size / h, size / w)
        new_w, new_h = int(round(w * scale)), int(round(h * scale))
        if (new_w, new_h) == (w, h):
            resized = img
        else:
            cv2 = _cv2()
            resized = cv2.resize(img, (new_w, new_h),
                                 interpolation=cv2.INTER_CUBIC)
        out = np.full((size, size, 3), self.config.infer.pad_value, np.uint8)
        out[:resized.shape[0], :resized.shape[1]] = resized
        return out, scale

    def predict_skeletons(self, img: np.ndarray, use_cpp: Optional[bool] = None,
                          scales: Optional[Tuple[float, ...]] = None,
                          angles: Tuple[float, ...] = (0.0,),
                          fixed_size: bool = False):
        """One BGR uint8 image -> (keypoints (N, 18, 3), scores (N,), aux).
        ``scales``/``angles`` run multi-scale / rotation TTA; ``fixed_size``
        letterboxes into one boxsize^2 canvas (coordinates are mapped back
        to the original image)."""
        icfg = self.config.infer
        img_h_override = content_override = None
        scale = 1.0
        if fixed_size:
            orig_hw = img.shape[:2]
            img, scale = self.letterbox(img)
            img_h_override = orig_hw[0] * scale
            content_override = (orig_hw[0] * scale, orig_hw[1] * scale)
        packed, paf, heat, orig = self.predict_maps_tta(
            img, *_tta_key(scales, angles), img_h_override=img_h_override,
            content_hw_override=content_override)
        buf = packed.cpu().numpy()                    # the single D2H fetch
        peaks_np, conns_np = unpack_results(buf, icfg.max_peaks)
        table, cands = self._group(peaks_np, conns_np, use_cpp)
        kps, scores = group.humans_to_keypoints(table, cands)
        if scale != 1.0:
            kps[:, :, :2] *= 1.0 / scale              # letterbox -> original
        aux = dict(paf=paf, heat=heat, peaks=peaks_np,
                   person_table=table, joint_candidates=cands,
                   orig_hw=orig_hw if fixed_size else orig,
                   peaks_dropped=np.maximum(peaks_np.n_raw - icfg.max_peaks, 0))
        return kps, scores, aux

    def predict_batch(self, imgs: np.ndarray, img_hs: Optional[np.ndarray] = None,
                      use_cpp: Optional[bool] = None,
                      content_hws: Optional[np.ndarray] = None,
                      mesh=None, scales: Optional[Tuple[float, ...]] = None,
                      angles: Tuple[float, ...] = (0.0,)):
        """(B, H, W, 3) uint8 frames of one shape, already letterboxed ->
        a list of (keypoints, scores) per image. ``img_hs`` (B,) are the
        content heights for the length prior, ``content_hws`` (B, 2) the
        valid-content extents (default: the full canvas). ``scales``/
        ``angles`` run multi-scale / rotation TTA, uniform across the batch
        (the letterbox canvas makes the reference's per-image multiplier the
        scale itself)."""
        if mesh is not None:
            raise NotImplementedError("mesh-sharded serving is not ported")
        B, h, w = imgs.shape[:3]
        if img_hs is None:
            img_hs = np.full((B,), h, np.float32)
        if content_hws is None:
            content_hws = np.tile(np.float32([h, w]), (B, 1))
        packed, _, _ = self._run(imgs, np.asarray(img_hs, np.float32),
                                 np.asarray(content_hws, np.float32),
                                 *_tta_key(scales, angles))
        bufs = packed.cpu().numpy()                   # one fetch per batch
        P = self.config.infer.max_peaks
        out = []
        for b in range(B):
            peaks_np, conns_np = unpack_results(bufs[b], P)
            table, cands = self._group(peaks_np, conns_np, use_cpp)
            out.append(group.humans_to_keypoints(table, cands))
        return out
