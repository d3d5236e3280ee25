"""The port's two hand-written CUDA kernels: wrappers, plain versions and
launch counts.

  * ``nms`` (csrc/nms.cu) replaces the TPU kernel
    ``improved_body_parts_tpu/ops/pallas_kernels.py:nms_pallas``.
  * ``fused_peaks`` (csrc/fused_peaks.cu) replaces
    ``pallas_kernels.py:fused_peaks_pallas``.

Both are bound by device-memory bytes (each map is read once; the fused
kernel keeps its NMS map in shared memory for its P arg-max rounds, or, for
a map beyond one block's shared memory, in a global scratch that stays in
L2), so each is one launch; the notes at the top of each source say more. Both are pure compares, copies and integer arithmetic,
so a kernel and its plain version agree bit for bit.

A wrapper takes its plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel (on PyTorch's current stream, no
synchronisation; outputs allocated here with ``torch.empty``) or raises.
Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from improved_body_parts_tpu_torch.ops import build

_PLUS_OFFSETS = ((0, 1), (2, 1), (1, 0), (1, 2))
_SQUARE_OFFSETS = tuple((dy, dx) for dy in range(3) for dx in range(3)
                        if not (dy == 1 and dx == 1))
# dynamic shared memory one block of the fused kernel may hold (H100: 227 KB
# per block, less the kernel's 384 bytes of static shared memory)
FUSED_PEAKS_SMEM_BYTES = 232448 - 1024

_count_lock = threading.Lock()


def _count(wrapper) -> None:
    with _count_lock:
        wrapper.launches += 1


def reset_launch_counts() -> None:
    for wrapper in (nms, fused_peaks):
        wrapper.launches = 0


def _check_footprint(footprint: str) -> bool:
    if footprint not in ("plus", "square"):
        raise ValueError(f"unknown footprint {footprint!r}")
    return footprint == "plus"


def _check_cuda_input(heat: torch.Tensor) -> None:
    if heat.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {heat.device}")
    if heat.dtype != torch.float32 or heat.dim() != 3 or not heat.is_contiguous():
        raise ValueError("expected a contiguous (N, H, W) float32 tensor, got "
                         f"{heat.dtype} {tuple(heat.shape)}")


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


def nms(heat: torch.Tensor, thre: float = 0.1,
        footprint: str = "plus") -> torch.Tensor:
    """``nms_plain`` on the CPU; the CUDA kernel (csrc/nms.cu) on the card."""
    if heat.device.type == "cpu":
        return nms_plain(heat, thre, footprint)
    plus = _check_footprint(footprint)
    _check_cuda_input(heat)
    n, h, w = heat.shape
    if n > 65535:
        raise ValueError(f"at most 65535 maps per launch, got {n}")
    out = torch.empty_like(heat)
    lib = build.load()
    with torch.cuda.device(heat.device):
        err = lib.ibp_nms(heat.data_ptr(), out.data_ptr(), n, h, w,
                          float(thre), int(plus),
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"nms kernel launch failed: CUDA error {err}")
    _count(nms)
    return out


nms.launches = 0


# ---------------------------------------------------------------------------
# kernel 2: fused NMS -> top-P -> patch extraction
# ---------------------------------------------------------------------------

def fused_peaks_plain(heat: torch.Tensor, thre: float = 0.1,
                      max_peaks: int = 32, footprint: str = "plus",
                      win: int = 2):
    """heat (K, H, W) float32 -> (scores (K, P) float32, yx (K, P, 2) int32
    [y, x], n_raw (K,) int32, patches (K, P, 2*win+1, 2*win+1) float32).

    NMS, then P rounds of arg-max over the NMS map (highest score, lowest
    flat index on ties), each zeroing its cell; the patch around each pick
    comes from the ORIGINAL map, zero outside it. An exhausted map yields
    score 0 at cell (0, 0), as the TPU kernel does."""
    k, h, w = heat.shape
    keep = _nms_keep(heat, thre, footprint)
    nm = torch.where(keep, heat, torch.zeros((), dtype=heat.dtype,
                                             device=heat.device)).reshape(k, h * w)
    n_raw = keep.reshape(k, -1).sum(1).to(torch.int32)
    iota = torch.arange(h * w, device=heat.device)
    rows = torch.arange(k, device=heat.device)
    scores = torch.empty((k, max_peaks), dtype=torch.float32, device=heat.device)
    idx = torch.empty((k, max_peaks), dtype=torch.int64, device=heat.device)
    for p in range(max_peaks):
        best = nm.max(dim=1).values
        pick = torch.where(nm == best[:, None], iota, h * w).min(dim=1).values
        scores[:, p] = best
        idx[:, p] = pick
        nm[rows, pick] = 0.0
    cy, cx = idx // w, idx % w
    size = 2 * win + 1
    taps = torch.arange(size, device=heat.device)
    padded = F.pad(heat, (win, win, win, win))          # zeros outside
    patches = padded[rows[:, None, None, None],
                     cy[:, :, None, None] + taps[:, None],
                     cx[:, :, None, None] + taps[None, :]]
    yx = torch.stack([cy, cx], dim=-1).to(torch.int32)
    return scores, yx, n_raw, patches


def fused_peaks(heat: torch.Tensor, thre: float = 0.1, max_peaks: int = 32,
                footprint: str = "plus", win: int = 2):
    """``fused_peaks_plain`` on the CPU; the CUDA kernel
    (csrc/fused_peaks.cu) on the card. A map larger than one block's shared
    memory takes the kernel's variant that keeps its NMS map in a global
    scratch (same results, bit for bit)."""
    if heat.device.type == "cpu":
        return fused_peaks_plain(heat, thre, max_peaks, footprint, win)
    plus = _check_footprint(footprint)
    _check_cuda_input(heat)
    k, h, w = heat.shape
    size = 2 * win + 1
    if size * size > 1024 or max_peaks < 1:
        raise ValueError(f"unsupported win={win} / max_peaks={max_peaks}")
    dev = heat.device
    scores = torch.empty((k, max_peaks), dtype=torch.float32, device=dev)
    yx = torch.empty((k, max_peaks, 2), dtype=torch.int32, device=dev)
    n_raw = torch.empty((k,), dtype=torch.int32, device=dev)
    patches = torch.empty((k, max_peaks, size, size), dtype=torch.float32,
                          device=dev)
    # the NMS map of a map beyond shared memory; freed on return, which is
    # safe: the caching allocator reuses it only for later work on this stream
    scratch = (torch.empty_like(heat) if h * w * 4 > FUSED_PEAKS_SMEM_BYTES
               else None)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.ibp_fused_peaks(
            heat.data_ptr(), None if scratch is None else scratch.data_ptr(),
            scores.data_ptr(), yx.data_ptr(),
            n_raw.data_ptr(), patches.data_ptr(), k, h, w, max_peaks, win,
            float(thre), int(plus), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused_peaks kernel launch failed: CUDA error {err}")
    _count(fused_peaks)
    return scores, yx, n_raw, patches


fused_peaks.launches = 0
