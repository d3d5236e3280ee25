"""Plain post-processing reference: flip average, peaks, limb scoring,
greedy selection and the Python person assembly.

A frozen copy of the port's ``ops/kernels.nms_plain``, ``ops/peaks.py``
(the unfused bicubic route), ``ops/limbs.py``, ``ops/group.py`` and the
flip average of ``infer/predict.py``, kept with the benchmark so that a
change to the program cannot move the yardstick. It imports nothing of
the program. The CUDA ``nms`` kernel's plain version stands in its place.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perf_bench.reference.layout import (
    FLIP_CHANNEL_ORD, LIMBS_CONN, NUM_LAYERS, NUM_PARTS, PAF_LAYERS,
    InferenceConfig,
)

_PLUS_OFFSETS = ((0, 1), (2, 1), (1, 0), (1, 2))
_SQUARE_OFFSETS = tuple((dy, dx) for dy in range(3) for dx in range(3)
                        if not (dy == 1 and dx == 1))


def _check_footprint(footprint: str) -> bool:
    if footprint not in ("plus", "square"):
        raise ValueError(f"unknown footprint {footprint!r}")
    return footprint == "plus"


def _nms_keep(x: torch.Tensor, thre: float, footprint: str) -> torch.Tensor:
    plus = _check_footprint(footprint)
    h, w = x.shape[-2:]
    padded = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
    hmax = x
    for dy, dx in (_PLUS_OFFSETS if plus else _SQUARE_OFFSETS):
        hmax = torch.maximum(hmax, padded[..., dy:dy + h, dx:dx + w])
    return (x >= hmax) & ((x > thre) if plus else (x >= thre))


# ---------------------------------------------------------------------------
# kernel 1: NMS
# ---------------------------------------------------------------------------

def nms_plain(heat: torch.Tensor, thre: float = 0.1,
              footprint: str = "plus") -> torch.Tensor:
    """(N, H, W) float32 -> NMS'd maps: x where x is a local max over the
    4-neighbourhood ("plus", x > thre) or 3x3 window ("square", x >= thre)
    with -inf outside the map, else 0."""
    keep = _nms_keep(heat, thre, footprint)
    return torch.where(keep, heat, torch.zeros((), dtype=heat.dtype,
                                               device=heat.device))


# cv2 INTER_CUBIC's Keys kernel parameter (the reference's AP numbers)
CV2_CUBIC_A = -0.75
WIN = 2     # the refinement patch is (2*WIN+1)^2 cells


class PeakTable(NamedTuple):
    """Fixed-size per-joint-type peak table (K joint types, P slots), with a
    leading batch dimension when it comes from ``find_peaks``."""
    xy: torch.Tensor          # (B, K, P, 2) float32 refined (x, y) in pixels
    score: torch.Tensor       # (B, K, P) float32
    valid: torch.Tensor       # (B, K, P) bool
    grid_yx: torch.Tensor     # (B, K, P, 2) int32 peak cell on the stride map
    n_raw: torch.Tensor = None  # (B, K) int32 NMS peaks before the top-P cut


def resized_coords(coords: torch.Tensor, factor: float) -> torch.Tensor:
    """Half-pixel mapping between resolutions (parse_skeletons.py:122-123)."""
    return (coords.to(torch.float32) + 0.5) * factor - 0.5


# ---------------------------------------------------------------------------
# cv2-exact cubic upsampling as a linear basis (host numpy, cached)
# ---------------------------------------------------------------------------

def keys_cubic_weights(f: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic-convolution weights for the 4 taps (x0-1, x0, x0+1, x0+2)
    at fractional position f in [0, 1). Shape (..., 4)."""
    f = np.asarray(f, np.float64)
    t = np.stack([1.0 + f, f, 1.0 - f, 2.0 - f], axis=-1)
    at = np.abs(t)
    near = (a + 2) * at ** 3 - (a + 3) * at ** 2 + 1          # |t| <= 1
    far = a * (at ** 3 - 5 * at ** 2 + 8 * at - 4)            # 1 < |t| < 2
    return np.where(at <= 1.0, near, far)


def resize1d_cubic_matrix(s_in: int, s_out: int, a: float) -> np.ndarray:
    """(s_in, s_out) matrix M with (signal @ M) == cv2.resize INTER_CUBIC of
    the 1-D signal (half-pixel mapping, replicate border, Keys ``a``)."""
    m = np.zeros((s_in, s_out), np.float64)
    scale = s_in / s_out
    for X in range(s_out):
        x = (X + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        w = keys_cubic_weights(x - x0, a)
        for k in range(4):
            m[min(max(x0 - 1 + k, 0), s_in - 1), X] += w[k]
    return m


@functools.lru_cache(maxsize=None)
def _border_case_bases(win: int, up: int, a: float):
    """Per-border-case 1-D upsample bases for the cropped-patch refinement
    (the reference crops the patch at map borders, parse_skeletons.py:
    143-153). Case 0 is interior, 1..win the low side clipped by that many
    cells, win+1..2*win the high side clipped by c-win. Returns
    (bases (cases, size, size*up) float32, valid (cases, size*up) bool)."""
    size = 2 * win + 1
    bases = np.zeros((size, size, size * up), np.float64)
    valid = np.zeros((size, size * up), bool)
    for case in range(size):
        lo_clip = case if case <= win else 0
        hi_clip = case - win if case > win else 0
        s = size - lo_clip - hi_clip
        bases[case, lo_clip:lo_clip + s, :s * up] = resize1d_cubic_matrix(
            s, s * up, a)
        valid[case, :s * up] = True
    return bases.astype(np.float32), valid


def _border_case_index(c: torch.Tensor, size: int, win: int) -> torch.Tensor:
    """Case index for coordinate c on an axis of ``size`` cells."""
    lo = torch.clamp(win - c, min=0)
    hi = torch.clamp(c + win - (size - 1), min=0)
    return torch.where(lo > 0, lo, torch.where(hi > 0, hi + win, 0))


def _gather_patches(maps: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
                    win: int) -> torch.Tensor:
    """maps (N, H, W), cy/cx (N, P) -> (N, P, S, S) patches around each cell,
    zero outside the map."""
    n = maps.shape[0]
    size = 2 * win + 1
    padded = torch.nn.functional.pad(maps, (win, win, win, win))
    taps = torch.arange(size, device=maps.device)
    rows = torch.arange(n, device=maps.device)[:, None, None, None]
    return padded[rows, cy[:, :, None, None] + taps[:, None],
                  cx[:, :, None, None] + taps[None, :]]


def _refine_bicubic_from_patch(patch: torch.Tensor, cy: torch.Tensor,
                               cx: torch.Tensor, h: int, w: int, stride: int,
                               cubic_a: float, up: Optional[int] = None):
    """Cropped-patch bicubic-upsample arg-max refinement into image pixels
    (parse_skeletons.py:141-173): patch (..., S, S) with zeros outside the
    map, cy/cx (...). ``up`` is the patch upsample factor: ``stride`` (the
    default) reproduces the reference's 1 px grid, a larger one samples the
    same cubic surface on a finer grid. Returns (x_img, y_img, score)."""
    up = up or stride
    size = 2 * WIN + 1
    bases_np, valids_np = _border_case_bases(WIN, up, cubic_a)
    bases = torch.from_numpy(bases_np).to(patch.device)
    valids = torch.from_numpy(valids_np).to(patch.device)
    iy = _border_case_index(cy, h, WIN)
    ix = _border_case_index(cx, w, WIN)
    by, bx = bases[iy], bases[ix]                       # (..., S, S*up)
    patch_up = torch.matmul(torch.matmul(by.transpose(-1, -2), patch), bx)
    ok = valids[iy][..., :, None] & valids[ix][..., None, :]
    patch_up = torch.where(ok, patch_up, float("-inf"))
    upsz = size * up
    flat = patch_up.flatten(-2)
    flat_idx = torch.argmax(flat, dim=-1)               # first max, like jnp
    score = torch.gather(flat, -1, flat_idx[..., None])[..., 0]
    uy, ux = flat_idx // upsz, flat_idx % upsz
    y0 = torch.clamp(cy - WIN, min=0)
    x0 = torch.clamp(cx - WIN, min=0)
    dy = (uy.to(torch.float32) - resized_coords(cy - y0, up)) * (float(stride) / up)
    dx = (ux.to(torch.float32) - resized_coords(cx - x0, up)) * (float(stride) / up)
    y_img = resized_coords(cy, stride) + dy
    x_img = resized_coords(cx, stride) + dx
    return x_img, y_img, score


def _refine_centroid(maps: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
                     stride: int, radius: int = 2):
    """Weighted-centroid refinement on the stride map, into image pixels
    (utils/util.py:188-213; score = the box mean). maps (N, h, w), cy/cx
    (N, P). A window that crosses the border keeps the raw cell and its
    value, as the reference does. The reference's ``np.mgrid`` swaps the
    two offset grids, so its x offset is the row (y) moment and vice versa;
    that is reproduced."""
    h, w = maps.shape[-2:]
    patch = _gather_patches(maps, cy, cx, radius)       # zeros outside
    fully_inb = ((cy >= radius) & (cy + radius <= h - 1)
                 & (cx >= radius) & (cx + radius <= w - 1))
    grid = torch.arange(-radius, radius + 1, device=maps.device,
                        dtype=torch.float32)
    total = patch.sum(dim=(-2, -1))
    denom = torch.clamp(total, min=1e-12)
    off_x = (patch * grid[:, None]).sum(dim=(-2, -1)) / denom    # the swap
    off_y = (patch * grid[None, :]).sum(dim=(-2, -1)) / denom
    box_mean = total / (2 * radius + 1) ** 2
    raw = torch.gather(maps.flatten(-2), 1, cy * w + cx)
    fx, fy = cx.to(torch.float32), cy.to(torch.float32)
    fx = torch.where(fully_inb, fx + off_x, fx)
    fy = torch.where(fully_inb, fy + off_y, fy)
    score = torch.where(fully_inb, box_mean, raw)
    return resized_coords(fx, stride), resized_coords(fy, stride), score


def find_peaks(heat: torch.Tensor, *, thre: float = 0.1, max_peaks: int = 32,
               stride: int = 4, cubic_a: float = CV2_CUBIC_A,
               content_hw: Optional[torch.Tensor] = None) -> PeakTable:
    """Up to ``max_peaks`` peaks per joint-type channel, per image, refined
    by the cropped-patch bicubic arg-max ("plus" NMS footprint): the port's
    ``find_peaks(refine="bicubic", fused=False)``."""
    footprint = "plus"
    B, h, w, K = heat.shape
    dev = heat.device
    size = 2 * WIN + 1
    chan_first = heat.permute(0, 3, 1, 2).float().contiguous()   # (B, K, h, w)

    cell_ok = None
    if content_hw is not None:
        content_hw = content_hw.to(device=dev, dtype=torch.float32)
        row_ok = (torch.arange(h, device=dev, dtype=torch.float32) * stride
                  < content_hw[:, 0:1])
        col_ok = (torch.arange(w, device=dev, dtype=torch.float32) * stride
                  < content_hw[:, 1:2])
        cell_ok = (row_ok[:, :, None] & col_ok[:, None, :])[:, None]  # (B,1,h,w)

    nmsed = nms_plain(chan_first.reshape(B * K, h, w), thre,
                      footprint=footprint).reshape(B, K, h, w)
    if cell_ok is not None:
        nmsed = torch.where(cell_ok, nmsed, 0.0)
    flat = nmsed.reshape(B, K, h * w)
    n_raw = (flat > 0.0).sum(-1).to(torch.int32)
    top_scores, top_idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    top_scores = top_scores[..., :max_peaks]
    top_idx = top_idx[..., :max_peaks]
    cy, cx = top_idx // w, top_idx % w
    valid = top_scores > 0.0
    maps = chan_first.reshape(B * K, h, w)
    cy_f, cx_f = cy.reshape(B * K, -1), cx.reshape(B * K, -1)
    patches = _gather_patches(maps, cy_f, cx_f, WIN).reshape(
        B, K, max_peaks, size, size)
    xs, ys, scores = _refine_bicubic_from_patch(patches, cy, cx, h, w, stride,
                                                cubic_a)
    xy = torch.stack([xs, ys], dim=-1)
    scores = torch.where(valid, scores, 0.0)
    if content_hw is not None:
        inb = ((xy[..., 0] < content_hw[:, None, None, 1])
               & (xy[..., 1] < content_hw[:, None, None, 0]))
        scores = torch.where(inb, scores, 0.0)
        valid = valid & inb
    return PeakTable(xy=xy.float(), score=scores.float(), valid=valid,
                     grid_yx=torch.stack([cy, cx], dim=-1).to(torch.int32),
                     n_raw=n_raw)


class ConnectionCandidates(NamedTuple):
    """Dense candidate scores for every (limb type, src slot, dst slot)."""
    conn_score: torch.Tensor  # (B, L, P, P) mean limb-map sample + length prior
    overall: torch.Tensor     # (B, L, P, P) 0.5*conn + 0.25*src + 0.25*dst
    limb_len: torch.Tensor    # (B, L, P, P)
    valid: torch.Tensor       # (B, L, P, P) bool


class Connections(NamedTuple):
    """Greedy-selected connections per limb type (P slots each)."""
    src_slot: torch.Tensor    # (B, L, P) int32
    dst_slot: torch.Tensor    # (B, L, P) int32
    score: torch.Tensor       # (B, L, P) float32 conn_score
    limb_len: torch.Tensor    # (B, L, P) float32
    valid: torch.Tensor       # (B, L, P) bool


def _keys_weights(f: torch.Tensor, a: float):
    """Keys weights of the taps at offsets -1, 0, 1, 2 for fraction f."""
    out = []
    for t in (1.0 + f, f, 1.0 - f, 2.0 - f):
        at = torch.abs(t)
        at2 = at * at
        at3 = at2 * at
        near = (a + 2) * at3 - (a + 3) * at2 + 1
        far = a * (at3 - 5 * at2 + 8 * at - 4)
        out.append(torch.where(at <= 1.0, near, far))
    return out


def cubic_sample(maps: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                 a: float = CV2_CUBIC_A) -> torch.Tensor:
    """Keys-cubic samples of ``maps`` (N, h, w) at float coords fx, fy
    (N, M), taps clamped to the border (cv2's replicate border). A gather of
    the 4x4 taps, accumulated row by row, never holds more than one (N, M)
    tap at a time."""
    n, h, w = maps.shape
    flat = maps.reshape(n, h * w)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx = _keys_weights(fx - x0, a)
    wy = _keys_weights(fy - y0, a)
    x0, y0 = x0.long(), y0.long()
    cols = [torch.clamp(x0 + (j - 1), 0, w - 1) for j in range(4)]
    out = None
    for j in range(4):
        col = None                       # sum over rows at tap column j
        for i in range(4):
            row = torch.clamp(y0 + (i - 1), 0, h - 1)
            tap = torch.gather(flat, 1, row * w + cols[j]) * wy[i]
            col = tap if col is None else col + tap
        term = col * wx[j]
        out = term if out is None else out + term
    return out


def bilinear_sample(maps: torch.Tensor, fx: torch.Tensor,
                    fy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``maps`` (N, h, w) at float coords fx, fy (N, M),
    clamped to the map (the JAX package's ``bilinear_sample``)."""
    n, h, w = maps.shape
    flat = maps.reshape(n, h * w)
    x = torch.clamp(fx, 0.0, w - 1.0)
    y = torch.clamp(fy, 0.0, h - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    ix0, iy0 = x0.long(), y0.long()
    ix1 = torch.clamp(ix0 + 1, max=w - 1)
    iy1 = torch.clamp(iy0 + 1, max=h - 1)
    fx, fy = x - x0, y - y0

    def tap(iy, ix):
        return torch.gather(flat, 1, iy * w + ix)

    return (tap(iy0, ix0) * (1 - fx) * (1 - fy) + tap(iy0, ix1) * fx * (1 - fy)
            + tap(iy1, ix0) * (1 - fx) * fy + tap(iy1, ix1) * fx * fy)


def score_connections(paf: torch.Tensor, peaks_xy: torch.Tensor,
                      peaks_score: torch.Tensor, peaks_valid: torch.Tensor,
                      img_h: torch.Tensor, *, mid_num: int = 20,
                      stride: int = 4, thre2: float = 0.1,
                      connect_ration: float = 0.8,
                      sampling: str = "reference") -> ConnectionCandidates:
    """Score all candidate limbs.

    paf (B, h, w, L) stride-resolution limb maps; peaks_xy (B, K, P, 2)
    in padded-image pixels; peaks_score/peaks_valid (B, K, P); img_h (B,)
    ORIGINAL image heights (length prior, parse_skeletons.py:367)."""
    if sampling not in ("reference", "bilinear"):
        raise ValueError(f"unknown sampling {sampling!r}")
    reference = sampling == "reference"
    dev = paf.device
    limbs = torch.as_tensor(LIMBS_CONN, device=dev, dtype=torch.long)
    src_xy = peaks_xy[:, limbs[:, 0]]                    # (B, L, P, 2)
    dst_xy = peaks_xy[:, limbs[:, 1]]
    src_score = peaks_score[:, limbs[:, 0]]              # (B, L, P)
    dst_score = peaks_score[:, limbs[:, 1]]
    src_valid = peaks_valid[:, limbs[:, 0]]
    dst_valid = peaks_valid[:, limbs[:, 1]]

    diff = dst_xy[:, :, None, :, :] - src_xy[:, :, :, None, :]   # (B,L,P,P,2)
    limb_len = torch.sqrt(torch.sum(diff * diff, dim=-1))        # (B,L,P,P)
    if reference:
        # n = min(round(len + 1), mid_num), at least 1 (parse_skeletons.py:353)
        n_samples = torch.clamp(torch.round(limb_len + 1), max=mid_num)
        n_samples = torch.clamp(n_samples.to(torch.int32), min=1)
    else:
        n_samples = torch.clamp(torch.round(limb_len) + 1, max=mid_num)
        n_samples = torch.clamp(n_samples.to(torch.int32), min=2)
    slot = torch.arange(mid_num, device=dev, dtype=torch.float32)
    t = slot / torch.clamp(n_samples[..., None] - 1, min=1).to(torch.float32)
    sample_mask = slot < n_samples[..., None]                    # (B,L,P,P,S)
    t = torch.clamp(t, max=1.0)

    pts = src_xy[:, :, :, None, None, :] + t[..., None] * diff[:, :, :, :, None, :]
    if reference:
        pts = torch.round(pts)      # integer pixels of the virtual x4 map
    # mapped to stride-map coords by the half-pixel convention
    # (parse_skeletons.py:122-123)
    fx = (pts[..., 0] + 0.5) / stride - 0.5
    fy = (pts[..., 1] + 0.5) / stride - 0.5

    B, L = fx.shape[:2]
    paf_cl = paf.permute(0, 3, 1, 2).float().reshape(B * L, *paf.shape[1:3])
    sample = cubic_sample if reference else bilinear_sample
    samples = sample(paf_cl, fx.reshape(B * L, -1),
                     fy.reshape(B * L, -1)).reshape(fx.shape)

    n_f = n_samples.to(torch.float32)
    mean_paf = torch.sum(torch.where(sample_mask, samples, 0.0), dim=-1) / n_f
    img_h = img_h.to(device=dev, dtype=torch.float32)[:, None, None, None]
    conn_score = mean_paf + torch.clamp(
        0.5 * img_h / torch.clamp(limb_len, min=1e-6) - 1.0, max=0.0)

    passing = torch.sum((samples > thre2) & sample_mask, dim=-1)
    criterion1 = passing > n_f * connect_ration        # parse_skeletons.py:373
    criterion2 = conn_score > 0.0
    valid = (criterion1 & criterion2 & (limb_len > 0.0)
             & src_valid[..., :, None] & dst_valid[..., None, :])
    overall = (0.5 * conn_score + 0.25 * src_score[..., :, None]
               + 0.25 * dst_score[..., None, :])
    return ConnectionCandidates(conn_score=conn_score, overall=overall,
                                limb_len=limb_len, valid=valid)


def select_connections(cand: ConnectionCandidates,
                       peaks_valid: torch.Tensor) -> Connections:
    """Greedy one-to-one selection per (image, limb type) by descending
    overall score, stopping after min(#src, #dst) acceptances
    (parse_skeletons.py:390-408): P rounds of masked arg-max, vectorised
    over (B, L). Ties take the lowest flat index (arg-max's first maximum),
    matching a stable descending sort."""
    B, L, P, _ = cand.overall.shape
    dev = cand.overall.device
    limbs = torch.as_tensor(LIMBS_CONN, device=dev, dtype=torch.long)
    n_src = peaks_valid[:, limbs[:, 0]].sum(-1)              # (B, L)
    n_dst = peaks_valid[:, limbs[:, 1]].sum(-1)
    cap = torch.minimum(n_src, n_dst)
    neg_inf = float("-inf")
    overall = torch.where(cand.valid, cand.overall, neg_inf).reshape(B, L, P * P)
    score = cand.conn_score.reshape(B, L, P * P)
    length = cand.limb_len.reshape(B, L, P * P)

    used_src = torch.zeros((B, L, P), dtype=torch.bool, device=dev)
    used_dst = torch.zeros_like(used_src)
    outs = {name: [] for name in ("src", "dst", "score", "len", "valid")}
    for k in range(P):
        blocked = (used_src[..., :, None] | used_dst[..., None, :]).reshape(B, L, P * P)
        masked = torch.where(blocked, neg_inf, overall)
        idx = torch.argmax(masked, dim=-1)                   # (B, L)
        best = torch.gather(masked, -1, idx[..., None])[..., 0]
        ok = (best > neg_inf) & (k < cap)
        i, j = idx // P, idx % P
        outs["src"].append(torch.where(ok, i, 0))
        outs["dst"].append(torch.where(ok, j, 0))
        outs["score"].append(torch.where(
            ok, torch.gather(score, -1, idx[..., None])[..., 0], 0.0))
        outs["len"].append(torch.where(
            ok, torch.gather(length, -1, idx[..., None])[..., 0], 0.0))
        outs["valid"].append(ok)
        used_src = used_src | (torch.nn.functional.one_hot(i, P).bool() & ok[..., None])
        used_dst = used_dst | (torch.nn.functional.one_hot(j, P).bool() & ok[..., None])
    return Connections(
        src_slot=torch.stack(outs["src"], -1).to(torch.int32),
        dst_slot=torch.stack(outs["dst"], -1).to(torch.int32),
        score=torch.stack(outs["score"], -1).float(),
        limb_len=torch.stack(outs["len"], -1).float(),
        valid=torch.stack(outs["valid"], -1))


def connections_to_list(conns, P: int, limbs_conn=LIMBS_CONN) -> List[np.ndarray]:
    """Host numpy connection tables of ONE image -> the reference's list of
    (k, 6) arrays [src_peak_id, dst_peak_id, score, src_slot, dst_slot,
    limb_len] per limb type, peak id = joint_type * P + slot."""
    out = []
    for l, (fr, to) in enumerate(np.asarray(limbs_conn)):
        m = np.asarray(conns.valid[l])
        rows = np.zeros((int(m.sum()), 6), np.float64)
        ss = np.asarray(conns.src_slot[l])[m]
        ds = np.asarray(conns.dst_slot[l])[m]
        rows[:, 0] = fr * P + ss
        rows[:, 1] = to * P + ds
        rows[:, 2] = np.asarray(conns.score[l])[m]
        rows[:, 3] = ss
        rows[:, 4] = ds
        rows[:, 5] = np.asarray(conns.limb_len[l])[m]
        out.append(rows)
    return out


def build_joint_candidates(peaks_xy: np.ndarray, peaks_score: np.ndarray,
                           peaks_valid: np.ndarray) -> np.ndarray:
    """Flatten (K,P,...) peak tables into the (K*P, 4) candidate array
    [x, y, score, peak_id] with peak_id = joint_type * P + slot."""
    K, P = peaks_score.shape
    out = np.zeros((K * P, 4), np.float64)
    out[:, 0] = peaks_xy[..., 0].reshape(-1)
    out[:, 1] = peaks_xy[..., 1].reshape(-1)
    out[:, 2] = np.where(peaks_valid.reshape(-1), peaks_score.reshape(-1), 0.0)
    out[:, 3] = np.arange(K * P)
    return out


def find_humans(connected_limbs: Sequence[np.ndarray],
                joint_candidates: np.ndarray,
                cfg: InferenceConfig = InferenceConfig(),
                limbs_conn: np.ndarray = LIMBS_CONN) -> Tuple[np.ndarray, np.ndarray]:
    """Assemble connections into persons.

    connected_limbs: per limb type, (k, 6) rows
      [src_peak_id, dst_peak_id, conn_score, src_idx, dst_idx, limb_len].
    Returns (person_table (N, 20, 2), joint_candidates).
    """
    len_rate = cfg.len_rate
    connection_tole = cfg.connection_tole
    delete_shared = cfg.remove_recon

    persons: List[np.ndarray] = []

    for limb_type in range(len(limbs_conn)):
        conns = connected_limbs[limb_type]
        if conns is None or len(conns) == 0:
            continue
        src_type, dst_type = int(limbs_conn[limb_type][0]), int(limbs_conn[limb_type][1])

        for row in conns:
            src_pid, dst_pid, conn_score = row[0], row[1], row[2]
            limb_len = row[-1]

            assoc = []
            for pi, p in enumerate(persons):
                if p[src_type, 0] == src_pid or p[dst_type, 0] == dst_pid:
                    if len(assoc) >= 2:
                        # reference prints an error and skips extras
                        continue
                    assoc.append(pi)

            if len(assoc) == 1:
                p = persons[assoc[0]]
                p_dst_pid = p[dst_type, 0]
                p_dst_score = p[dst_type, 1]
                p_max_len = p[-1, 1]
                if int(p_dst_pid) == -1 and p_max_len * len_rate > limb_len:
                    # dst joint unset for this person: claim it
                    p[dst_type] = [dst_pid, conn_score]
                    p[-1, 0] += 1
                    p[-1, 1] = max(limb_len, p_max_len)
                    p[-2, 0] += joint_candidates[int(dst_pid), 2] + conn_score
                elif (int(p_dst_pid) != int(dst_pid)
                      and p_dst_score <= conn_score
                      and p_max_len * len_rate > limb_len):
                    # replace a lower-scored different dst joint
                    p[-2, 0] -= joint_candidates[int(p_dst_pid), 2] + p_dst_score
                    p[dst_type] = [dst_pid, conn_score]
                    p[-1, 1] = max(limb_len, p_max_len)
                    p[-2, 0] += joint_candidates[int(dst_pid), 2] + conn_score
                elif (int(p_dst_pid) == int(dst_pid)
                      and p_dst_score <= conn_score):
                    # same dst joint seen again with a better score
                    p[-2, 0] -= joint_candidates[int(p_dst_pid), 2] + p_dst_score
                    p[dst_type] = [dst_pid, conn_score]
                    p[-1, 1] = max(limb_len, p_max_len)
                    p[-2, 0] += joint_candidates[int(dst_pid), 2] + conn_score

            elif len(assoc) == 2:
                p1 = persons[assoc[0]]
                p2 = persons[assoc[1]]
                p1_max_len = p1[-1, 1]
                member1 = (p1[:-2, 0] >= 0).astype(int)
                member2 = (p2[:-2, 0] >= 0).astype(int)
                if not np.any(member1 + member2 == 2):
                    # disjoint: merge p2 into p1 when confident enough
                    min1 = np.min(p1[:-2, 1][member1 == 1])
                    min2 = np.min(p2[:-2, 1][member2 == 1])
                    if (conn_score >= connection_tole * min(min1, min2)
                            and limb_len < p1_max_len * len_rate):
                        p1[:-2] = np.maximum(p1[:-2], p2[:-2])
                        p1[-1, 0] += p2[-1, 0]
                        p1[-1, 1] = max(limb_len, p1_max_len)
                        p1[-2, 0] += p2[-2, 0] + conn_score
                        del persons[assoc[1]]
                elif delete_shared:
                    # a joint is claimed by two persons: drop the weaker claim
                    p1_pids = p1[:-2, 0]
                    p2_pids = p2[:-2, 0]
                    if src_pid in p1_pids:
                        c1 = int(np.flatnonzero(p1_pids == src_pid)[0])
                        c2 = int(np.flatnonzero(p2_pids == dst_pid)[0])
                    else:
                        c1 = int(np.flatnonzero(p1_pids == dst_pid)[0])
                        c2 = int(np.flatnonzero(p2_pids == src_pid)[0])
                    if conn_score >= p1[c1, 1] and conn_score >= p2[c2, 1]:
                        if p1[c1, 1] > p2[c2, 1]:
                            low, del_c = assoc[1], c2
                        else:
                            low, del_c = assoc[0], c1
                        lp = persons[low]
                        lp[-2, 0] -= joint_candidates[int(lp[del_c, 0]), 2] + lp[del_c, 1]
                        lp[del_c, 0] = -1
                        lp[del_c, 1] = -1
                        lp[-1, 0] -= 1

            else:
                # nobody claimed these joints: spawn a new person
                p = -1 * np.ones((NUM_PARTS + 2, 2))
                p[src_type] = [src_pid, conn_score]
                p[dst_type] = [dst_pid, conn_score]
                p[-1] = [2, limb_len]
                p[-2, 0] = (joint_candidates[int(src_pid), 2]
                            + joint_candidates[int(dst_pid), 2] + conn_score)
                persons.append(p)

    # cull: too few parts or too low mean score (parse_skeletons.py:593-598)
    kept = [p for p in persons
            if p[-1, 0] >= cfg.min_person_parts
            and p[-2, 0] / p[-1, 0] >= cfg.min_person_score]
    if kept:
        table = np.stack(kept, axis=0)
    else:
        table = np.zeros((0, NUM_PARTS + 2, 2))
    return table, joint_candidates


def humans_to_keypoints(person_table: np.ndarray,
                        joint_candidates: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Extract per-person keypoints and scores.

    Returns (keypoints (N, 18, 3) with [x, y, visible], scores (N,)) where
    score = accumulated_score / part_count — the reference's improved
    ``score/count`` formula worth +0.3 AP (evaluate.py:151, README.md:24-26).
    """
    n = len(person_table)
    kps = np.zeros((n, NUM_PARTS, 3), np.float64)
    scores = np.zeros((n,), np.float64)
    for i, p in enumerate(person_table):
        for j in range(NUM_PARTS):
            pid = int(p[j, 0])
            if pid >= 0:
                x, y = joint_candidates[pid, 0], joint_candidates[pid, 1]
                kps[i, j] = [x, y, 1.0 if (x > 0 or y > 0) else 0.0]
        scores[i] = p[-2, 0] / p[-1, 0]
    return kps, scores


def flip_average(orig: torch.Tensor, flipped: torch.Tensor) -> torch.Tensor:
    """Maps of the frames and of their mirror images (B, h, w, 50) -> the
    flip average: the mirror's maps flipped back, their channels permuted
    (left and right swapped), and the mean of the two."""
    order = torch.as_tensor(FLIP_CHANNEL_ORD, dtype=torch.long,
                            device=orig.device)
    return (orig + flipped.flip(2)[..., order]) * 0.5


def skeletons(avg: torch.Tensor, img_hs: torch.Tensor,
              content_hws: torch.Tensor, stride: int = 4,
              icfg: InferenceConfig = InferenceConfig()) -> list:
    """Flip-averaged maps (B, h, w, 50) -> a list of (keypoints (N, 18, 3),
    scores (N,)) a frame: peaks, limb scores, greedy selection, then the
    Python assembly on the host."""
    paf = avg[..., :PAF_LAYERS]
    heat = avg[..., PAF_LAYERS:NUM_LAYERS]
    peaks = find_peaks(heat[..., :NUM_PARTS], thre=icfg.thre1,
                       max_peaks=icfg.max_peaks, stride=stride,
                       content_hw=content_hws)
    cand = score_connections(paf, peaks.xy, peaks.score, peaks.valid, img_hs,
                             mid_num=icfg.mid_num, stride=stride,
                             thre2=icfg.thre2,
                             connect_ration=icfg.connect_ration)
    conns = select_connections(cand, peaks.valid)
    P = icfg.max_peaks
    host_peaks = PeakTable(*(None if t is None else t.cpu().numpy()
                             for t in peaks))
    host_conns = Connections(*(t.cpu().numpy() for t in conns))
    out = []
    for b in range(avg.shape[0]):
        conn_b = Connections(*(t[b] for t in host_conns))
        connected = connections_to_list(conn_b, P, LIMBS_CONN)
        cands = build_joint_candidates(host_peaks.xy[b], host_peaks.score[b],
                                       host_peaks.valid[b])
        table, cands = find_humans(connected, cands, icfg)
        out.append(humans_to_keypoints(table, cands))
    return out
