"""The port's hand-written CUDA kernels: wrappers, plain versions and
launch counts.

  * ``nms`` (csrc/nms.cu) replaces the TPU kernel
    ``improved_body_parts_tpu/ops/pallas_kernels.py:nms_pallas``.
  * ``fused_peaks`` (csrc/fused_peaks.cu) replaces
    ``pallas_kernels.py:fused_peaks_pallas``.
  * ``int8_conv`` (csrc/int8_conv.cu) replaces XLA's s8 x s8 -> s32
    convolution of the int8 forward
    (``improved_body_parts_tpu/models/imhn.py`` ``ConvBlock(quant="int8")``).

``nms`` and ``fused_peaks`` are bound by device-memory bytes: each map is
read once, and each kernel is one launch. The fused kernel streams each
channel once and keeps no NMS map in memory, only sorted top-P key lists
(registers and shared memory); the notes at the top of each source say
more. Both are pure compares, copies and integer arithmetic, so a kernel and
its plain version agree bit for bit. ``int8_conv`` sums integers exactly
and rounds each float step as its plain version does, so it too agrees bit
for bit.

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

_count_lock = threading.Lock()


def _count(wrapper) -> None:
    with _count_lock:
        wrapper.launches += 1


def reset_launch_counts() -> None:
    for wrapper in (nms, fused_peaks, int8_conv):
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
    (csrc/fused_peaks.cu) on the card, one code path for every map size.
    Raises where ``min(max_peaks, H*W)`` keys exceed the kernel's top-P
    lists (25,600 keys in shared memory)."""
    if heat.device.type == "cpu":
        return fused_peaks_plain(heat, thre, max_peaks, footprint, win)
    plus = _check_footprint(footprint)
    _check_cuda_input(heat)
    k, h, w = heat.shape
    size = 2 * win + 1
    if size * size > 1024 or max_peaks < 1:
        raise ValueError(f"unsupported win={win} / max_peaks={max_peaks}")
    lib = build.load()
    if min(max_peaks, h * w) > lib.ibp_fused_peaks_max_list_keys():
        raise ValueError(f"max_peaks={max_peaks} on {h}x{w} maps exceeds the "
                         "kernel's top-P lists")
    dev = heat.device
    scores = torch.empty((k, max_peaks), dtype=torch.float32, device=dev)
    yx = torch.empty((k, max_peaks, 2), dtype=torch.int32, device=dev)
    n_raw = torch.empty((k,), dtype=torch.int32, device=dev)
    patches = torch.empty((k, max_peaks, size, size), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        err = lib.ibp_fused_peaks(
            heat.data_ptr(), scores.data_ptr(), yx.data_ptr(),
            n_raw.data_ptr(), patches.data_ptr(), k, h, w, max_peaks, win,
            float(thre), int(plus), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fused_peaks kernel launch failed: CUDA error {err}")
    _count(fused_peaks)
    return scores, yx, n_raw, patches


fused_peaks.launches = 0


# ---------------------------------------------------------------------------
# kernel 3: int8 convolution (quantize the input, s8 x s8 -> s32, dequantize)
# ---------------------------------------------------------------------------

def _conv_out(size: int, k: int, stride: int, padding: int, dilation: int) -> int:
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def int8_conv_plain(x: torch.Tensor, weight_q: torch.Tensor, bias: torch.Tensor,
                    w_scale: torch.Tensor, a_scale: torch.Tensor,
                    stride: int = 1, padding: int = 0, dilation: int = 1,
                    relu: bool = False) -> torch.Tensor:
    """x (N, H, W, Cin) float, weight_q (Cout, kh, kw, Cin) int8, bias and
    w_scale (Cout,) float32, a_scale 0-d float32 -> (N, Ho, Wo, Cout) in
    x's type: the JAX int8 ConvBlock's arithmetic in its order,
    ``clip(round(x_f32 / a_scale), ±127)`` (ties to even), the integer sum,
    ``acc_f32 * (a_scale * w_scale) + bias``, the cast, LeakyReLU(0.01).
    The sum is a float64 convolution of the integer-valued tensors, which is
    exact: |acc| <= 127^2 * kh * kw * Cin < 2^53."""
    xq = torch.clamp(torch.round(x.float() / a_scale), -127, 127)
    acc = int8_conv_sums(xq, weight_q, stride, padding, dilation)
    y = acc.float() * (a_scale * w_scale) + bias
    y = y.to(x.dtype)
    return F.leaky_relu(y, 0.01) if relu else y


def int8_conv_sums(xq: torch.Tensor, weight_q: torch.Tensor, stride: int = 1,
                   padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """The integer part of ``int8_conv_plain``: integer-valued NHWC ``xq``
    and a (Cout, kh, kw, Cin) kernel -> the (N, Ho, Wo, Cout) int32 sums,
    zero padded. A float64 convolution, exact below 2^53."""
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                   weight_q.permute(0, 3, 1, 2).double(), None, stride,
                   padding, dilation)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def int8_conv(x: torch.Tensor, weight_q: torch.Tensor, bias: torch.Tensor,
              w_scale: torch.Tensor, a_scale: torch.Tensor, stride: int = 1,
              padding: int = 0, dilation: int = 1,
              relu: bool = False) -> torch.Tensor:
    """``int8_conv_plain`` on the CPU; the CUDA kernel (csrc/int8_conv.cu)
    on the card, which takes contiguous NHWC float32 or bfloat16
    activations and a contiguous (Cout, kh, kw, Cin) int8 kernel, and
    returns a contiguous (N, Ho, Wo, Cout) tensor of x's type."""
    if x.device.type == "cpu":
        return int8_conv_plain(x, weight_q, bias, w_scale, a_scale, stride,
                               padding, dilation, relu)
    if x.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise ValueError("expected (N, H, W, Cin) float32 or bfloat16 "
                         f"activations, got {x.dtype} {tuple(x.shape)}")
    n, h, w, cin = x.shape
    if (weight_q.dtype != torch.int8 or weight_q.dim() != 4
            or weight_q.shape[3] != cin or weight_q.shape[1] != weight_q.shape[2]):
        raise ValueError(f"expected a (Cout, k, k, {cin}) int8 kernel, got "
                         f"{weight_q.dtype} {tuple(weight_q.shape)}")
    cout, k = weight_q.shape[0], weight_q.shape[1]
    for name, t, shape in (("bias", bias, (cout,)), ("w_scale", w_scale, (cout,)),
                           ("a_scale", a_scale, ())):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"expected {name} float32 {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    tensors = (x, weight_q, bias, w_scale)
    if not all(t.is_contiguous() for t in tensors) or weight_q.device != x.device:
        raise ValueError("int8_conv needs contiguous tensors on one device")
    ho = _conv_out(h, k, stride, padding, dilation)
    wo = _conv_out(w, k, stride, padding, dilation)
    if min(ho, wo, n, cout) < 1 or n * ho * wo >= 2 ** 31 // 128:
        raise ValueError(f"unsupported int8_conv shape {tuple(x.shape)} -> "
                         f"({n}, {ho}, {wo}, {cout})")
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.ibp_int8_conv(
            x.data_ptr(), weight_q.data_ptr(), bias.data_ptr(),
            w_scale.data_ptr(), a_scale.data_ptr(), out.data_ptr(), n, h, w,
            cin, cout, k, k, stride, padding, dilation, ho, wo, int(relu),
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"int8_conv kernel launch failed: CUDA error {err}")
    _count(int8_conv)
    return out


int8_conv.launches = 0
