"""Batched limb scoring (line integral over the limb maps) and greedy
one-to-one connection selection.

Port of ``improved_body_parts_tpu/ops/limbs.py`` (:50-319) with the batch
as a leading dimension. ``score_connections`` runs either sampling of the
JAX package:
  * "reference" (parse_skeletons.py:353-374): n = min(round(len + 1),
    mid_num) points per candidate limb, rounded to integer pixels of the
    virtual x4 cv2-cubic upsampled map and read from the stride map with
    the Keys a=-0.75 kernel;
  * "bilinear": n = min(round(len) + 1, mid_num), at least 2, unrounded
    sub-pixel points, bilinear reads of the stride map.
The stride map is read by direct gathers of the clamped taps; the JAX
package's one-hot matmul samplers were a workaround for gathers on the TPU.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from improved_body_parts_tpu_torch.configs import LIMBS_CONN
from improved_body_parts_tpu_torch.ops.peaks import CV2_CUBIC_A, PeakTable


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


def connections_to_numpy(conns: Connections, peaks: PeakTable,
                         limbs_conn=LIMBS_CONN) -> List[np.ndarray]:
    """Connection tables of ONE image (tensors, any device) -> the
    reference's list of (k, 6) arrays, as ``connections_to_list``; P comes
    from the peak table."""
    host = Connections(*(t.detach().cpu().numpy() for t in conns))
    return connections_to_list(host, peaks.score.shape[-1], limbs_conn)
