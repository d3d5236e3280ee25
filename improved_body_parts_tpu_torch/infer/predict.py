"""Batched flip-TTA inference: images -> skeletons, on the card.

Port of the serving part of ``improved_body_parts_tpu/infer/predict.py``:
[orig, h-flip] run as one batch through the model, the flip pair is
averaged with the channel permutation, peaks and limbs are found on the
stride-4 maps, and everything the host needs comes back as ONE packed
float32 buffer per image (same layout as the JAX package's), which the host
groups into people with the shared ``ops.group`` / ``ops.group_cpp``.
``improved_body_parts_tpu.infer.serving.PipelinedServer`` drives this
``Predictor`` unchanged.

Only single-scale, unrotated inference is ported; ``scales``/``angles``
other than ``(1.0,)``/``(0.0,)`` and ``mesh`` raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from improved_body_parts_tpu.configs import (
    CanonicalConfig, FLIP_CHANNEL_ORD, NUM_LAYERS, NUM_LIMBS, NUM_PARTS,
    PAF_LAYERS,
)
from improved_body_parts_tpu.ops import group
from improved_body_parts_tpu_torch.ops.limbs import (
    Connections, connections_to_list, score_connections, select_connections,
)
from improved_body_parts_tpu_torch.ops.peaks import PeakTable, find_peaks


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


def _check_single_scale(scales, angles, mesh=None) -> None:
    scales_t = tuple(scales) if scales is not None else (1.0,)
    if scales_t != (1.0,) or tuple(angles) != (0.0,):
        raise NotImplementedError("multi-scale / rotation TTA is not ported yet")
    if mesh is not None:
        raise NotImplementedError("mesh-sharded serving is not ported")


class Predictor:
    """Serving-path predictor over a port ``PoseNet`` living on ``device``.

    ``fused_peaks`` selects the fused peak kernel in post-processing. Peaks
    in the bucket/letterbox pad band are always invalidated (the reference
    ORIGINAL path, parse_skeletons.py:272-281)."""

    def __init__(self, model: torch.nn.Module,
                 config: CanonicalConfig = CanonicalConfig(), *,
                 device: torch.device, fused_peaks: bool = False):
        self.model = model
        self.config = config
        self.device = torch.device(device)
        self.fused_peaks = bool(fused_peaks)
        self._flip_ord = torch.as_tensor(FLIP_CHANNEL_ORD, dtype=torch.long,
                                         device=self.device)

    # -- device stages -------------------------------------------------------
    def _postprocess(self, avg: torch.Tensor, img_h: torch.Tensor,
                     content_hw: Optional[torch.Tensor] = None):
        """avg (B, h/4, w/4, 50) flip-averaged maps -> (packed (B, n), paf,
        heat). ``content_hw`` (B, 2) float [h, w] valid-content extents."""
        cfg, icfg = self.config, self.config.infer
        paf = avg[..., :PAF_LAYERS]
        heat = avg[..., PAF_LAYERS:NUM_LAYERS]
        peaks = find_peaks(heat[..., :NUM_PARTS], thre=icfg.thre1,
                           max_peaks=icfg.max_peaks, stride=cfg.stride,
                           content_hw=content_hw,
                           fused=self.fused_peaks)
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

    def _run(self, imgs_u8: np.ndarray, img_hs: np.ndarray,
             content_hws: np.ndarray):
        """(B, H, W, 3) uint8 -> (packed (B, n) on the device, paf, heat)."""
        with torch.inference_mode():
            imgs = torch.from_numpy(np.ascontiguousarray(imgs_u8)).to(
                self.device, non_blocking=True)
            imgs = imgs.to(torch.float32) / 255.0
            avg = self._flip_avg_maps(imgs)
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
            from improved_body_parts_tpu.ops import group_cpp
            if group_cpp.is_available():
                return group_cpp.find_humans(connected, cands, self.config.infer)
            if use_cpp:
                raise RuntimeError("C++ grouping requested but unavailable")
        return group.find_humans(connected, cands, self.config.infer)

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
        ``fixed_size`` letterboxes into one boxsize^2 canvas (coordinates
        are mapped back to the original image)."""
        _check_single_scale(scales, angles)
        icfg = self.config.infer
        orig_hw = img.shape[:2]
        if fixed_size:
            padded, scale = self.letterbox(img)
            content = (orig_hw[0] * scale, orig_hw[1] * scale)
            img_h = content[0]
        else:
            padded, content = pad_image_to_bucket(
                img, bucket=icfg.max_downsample, pad_value=icfg.pad_value,
                max_hw=(icfg.img_max_h, icfg.img_max_w))
            scale = 1.0
            img_h = content[0]
        packed, paf, heat = self._run(padded[None], np.float32([img_h]),
                                      np.float32([content]))
        buf = packed[0].cpu().numpy()                 # the single D2H fetch
        peaks_np, conns_np = unpack_results(buf, icfg.max_peaks)
        table, cands = self._group(peaks_np, conns_np, use_cpp)
        kps, scores = group.humans_to_keypoints(table, cands)
        if scale != 1.0:
            kps[:, :, :2] *= 1.0 / scale              # letterbox -> original
        aux = dict(paf=paf[0], heat=heat[0], peaks=peaks_np,
                   person_table=table, joint_candidates=cands,
                   orig_hw=orig_hw if fixed_size else content,
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
        valid-content extents (default: the full canvas)."""
        _check_single_scale(scales, angles, mesh)
        B, h, w = imgs.shape[:3]
        if img_hs is None:
            img_hs = np.full((B,), h, np.float32)
        if content_hws is None:
            content_hws = np.tile(np.float32([h, w]), (B, 1))
        packed, _, _ = self._run(imgs, np.asarray(img_hs, np.float32),
                                 np.asarray(content_hws, np.float32))
        bufs = packed.cpu().numpy()                   # one fetch per batch
        P = self.config.infer.max_peaks
        out = []
        for b in range(B):
            peaks_np, conns_np = unpack_results(bufs[b], P)
            table, cands = self._group(peaks_np, conns_np, use_cpp)
            out.append(group.humans_to_keypoints(table, cands))
        return out
