"""The port's hand-written CUDA kernels: wrappers, plain versions and
launch counts.

  * ``nms`` (csrc/nms.cu) replaces the TPU kernel
    ``improved_body_parts_tpu/ops/pallas_kernels.py:nms_pallas``.
  * ``fused_peaks`` (csrc/fused_peaks.cu) replaces
    ``pallas_kernels.py:fused_peaks_pallas``.
  * ``int8_quantize`` and ``int8_conv`` (csrc/int8_conv.cu) replace XLA's
    quantization and s8 x s8 -> s32 convolution of the int8 forward
    (``improved_body_parts_tpu/models/imhn.py`` ``ConvBlock(quant="int8")``).
    ``int8_conv`` has two kernels, chosen by shape (``int8_conv_route``):
    an implicit GEMM on wgmma fed by TMA, on int8 input, which can also
    write its output quantized for the next conv; and the first design's
    mma.sync kernel for the shapes TMA cannot take.

``nms`` and ``fused_peaks`` are bound by device-memory bytes: each map is
read once, and each kernel is one launch. The fused kernel streams each
channel once and keeps no NMS map in memory, only sorted top-P key lists
(registers and shared memory); the notes at the top of each source say
more. Both are pure compares, copies and integer arithmetic, so a kernel and
its plain version agree bit for bit. ``int8_conv`` sums integers exactly
and rounds each float step as its plain version does, so it too agrees bit
for bit, and so does ``int8_quantize``.

A wrapper takes its plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel (on PyTorch's current stream, no
synchronisation; outputs allocated here with ``torch.empty``) or raises.
Each wrapper counts its launches in ``<wrapper>.launches``;
``int8_conv.launches_by_route`` splits its count by kernel.
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


def _count(wrapper, route: str = "") -> None:
    with _count_lock:
        wrapper.launches += 1
        if route:
            wrapper.launches_by_route[route] += 1


def reset_launch_counts() -> None:
    for wrapper in (nms, fused_peaks, int8_quantize, int8_conv):
        wrapper.launches = 0
    int8_conv.launches_by_route = dict.fromkeys(int8_conv.launches_by_route, 0)


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
# kernels 3 and 4: int8 quantization and the int8 convolution (s8 x s8 ->
# s32, dequantize, [requantize])
# ---------------------------------------------------------------------------

def _conv_out(size: int, k: int, stride: int, padding: int, dilation: int) -> int:
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


# Float-in, float-out conv shapes (H, W, Cin, Cout, k) at which the
# mma_sync kernel was measured faster than the wgmma route (one quantize
# pass + the GEMM) on an H100: 1x1 convs with one 64-column block of
# outputs on large maps, where quantizing on load reads each activation
# once anyway (PERF.md §6 has both routes' rows). A call there with int8
# input or output keeps the wgmma route, which alone can make it.
_MMA_SYNC_FASTER = frozenset({(256, 256, 64, 64, 1), (64, 64, 256, 50, 1)})


def int8_conv_route(cin: int, stride: int, h: int = 0, w: int = 0,
                    cout: int = 0, k: int = 0, int8_io: bool = False) -> str:
    """The kernel a CUDA call of ``int8_conv`` takes, chosen by shape alone:

      * ``"wgmma"`` where ``stride == 1`` and ``Cin % 16 == 0`` (every 1x1
        and 3x3 conv of the model but the stem and the 1x1 merges on 50
        channels: 280 of a Canonical forward's 296): the input is int8
        (quantized by an ``int8_quantize`` launch first where it is a float
        tensor), loaded by TMA, and multiplied on wgmma. TMA needs each row
        of the NHWC tensor and of the (Cout, kh*kw*Cin) weight to be a
        multiple of 16 bytes.
      * ``"mma_sync"`` otherwise, and for a float-in, float-out call
        (``int8_io`` False) at a shape of ``_MMA_SYNC_FASTER``: the first
        design's kernel, which quantizes the float input as it loads it
        and writes the float output only.
    """
    if stride != 1 or cin % 16:
        return "mma_sync"
    if not int8_io and (h, w, cin, cout, k) in _MMA_SYNC_FASTER:
        return "mma_sync"
    return "wgmma"


def int8_quantize_plain(x: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    """x float -> int8 ``clip(round(x_f32 / a_scale), ±127)``, ties to
    even: the first step of the JAX int8 ConvBlock."""
    return torch.clamp(torch.round(x.float() / a_scale), -127, 127).to(torch.int8)


def int8_quantize(x: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    """``int8_quantize_plain`` on the CPU; the CUDA kernel
    (csrc/int8_conv.cu ``int8_quantize_kernel``) on the card, for a
    contiguous float32 or bfloat16 tensor: an int8 tensor of its shape."""
    if x.device.type == "cpu":
        return int8_quantize_plain(x, a_scale)
    if x.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {x.device}")
    if (x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError("expected a contiguous, 16-byte aligned float32 or "
                         f"bfloat16 tensor, got {x.dtype} {tuple(x.shape)}")
    _check_scale("a_scale", a_scale, x.device)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.ibp_int8_quantize(x.data_ptr(), out.data_ptr(), a_scale.data_ptr(),
                                    x.numel(), int(x.dtype == torch.bfloat16),
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"int8_quantize kernel launch failed: CUDA error {err}")
    _count(int8_quantize)
    return out


int8_quantize.launches = 0


def _check_scale(name: str, t: torch.Tensor, device, shape=()) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"expected {name} float32 {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _out_dtype(x: torch.Tensor, out_dtype) -> torch.dtype:
    if x.dtype == torch.int8:
        if out_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("an int8 input needs out_dtype float32 or bfloat16, "
                             f"got {out_dtype}")
        return out_dtype
    if out_dtype not in (None, x.dtype):
        raise ValueError(f"out_dtype {out_dtype} differs from the input's {x.dtype}")
    return x.dtype


def int8_conv_plain(x: torch.Tensor, weight_q: torch.Tensor, bias: torch.Tensor,
                    w_scale: torch.Tensor, a_scale: torch.Tensor,
                    stride: int = 1, padding: int = 0, dilation: int = 1,
                    relu: bool = False, out_dtype=None,
                    a_next=None) -> torch.Tensor:
    """x (N, H, W, Cin) float, or int8 already quantized with ``a_scale``;
    weight_q (Cout, kh, kw, Cin) int8, bias and w_scale (Cout,) float32,
    a_scale 0-d float32 -> (N, Ho, Wo, Cout) in ``out_dtype`` (x's type for
    a float x; named for an int8 x): the JAX int8 ConvBlock's arithmetic in
    its order, ``int8_quantize_plain(x, a_scale)``, the integer sum,
    ``acc_f32 * (a_scale * w_scale) + bias``, the cast, LeakyReLU(0.01).
    With ``a_next`` (0-d float32) the result is quantized again with it,
    ``int8_quantize_plain(y, a_next)``: the input the next conv would make.
    The sum is a float64 convolution of the integer-valued tensors, which is
    exact: |acc| <= 127^2 * kh * kw * Cin < 2^53."""
    dt = _out_dtype(x, out_dtype)
    xq = x if x.dtype == torch.int8 else int8_quantize_plain(x, a_scale)
    acc = int8_conv_sums(xq.float(), weight_q, stride, padding, dilation)
    y = acc.float() * (a_scale * w_scale) + bias
    y = y.to(dt)
    y = F.leaky_relu(y, 0.01) if relu else y
    return y if a_next is None else int8_quantize_plain(y, a_next)


def int8_conv_sums(xq: torch.Tensor, weight_q: torch.Tensor, stride: int = 1,
                   padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """The integer part of ``int8_conv_plain``: integer-valued NHWC ``xq``
    and a (Cout, kh, kw, Cin) kernel -> the (N, Ho, Wo, Cout) int32 sums,
    zero padded. A float64 convolution, exact below 2^53."""
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                   weight_q.permute(0, 3, 1, 2).double(), None, stride,
                   padding, dilation)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def _conv_checks(x, weight_q, bias, w_scale, a_scale, stride, padding,
                 dilation, a_next):
    """Validate a CUDA int8_conv call; returns (n, h, w, cin, cout, k, ho, wo)."""
    if x.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.int8) or x.dim() != 4:
        raise ValueError("expected (N, H, W, Cin) float32, bfloat16 or int8 "
                         f"activations, got {x.dtype} {tuple(x.shape)}")
    n, h, w, cin = x.shape
    if (weight_q.dtype != torch.int8 or weight_q.dim() != 4
            or weight_q.shape[3] != cin or weight_q.shape[1] != weight_q.shape[2]):
        raise ValueError(f"expected a (Cout, k, k, {cin}) int8 kernel, got "
                         f"{weight_q.dtype} {tuple(weight_q.shape)}")
    cout, k = weight_q.shape[0], weight_q.shape[1]
    _check_scale("bias", bias, x.device, (cout,))
    _check_scale("w_scale", w_scale, x.device, (cout,))
    _check_scale("a_scale", a_scale, x.device)
    if a_next is not None:
        _check_scale("a_next", a_next, x.device)
    tensors = (x, weight_q, bias, w_scale)
    if (not all(t.is_contiguous() for t in tensors) or weight_q.device != x.device
            or x.data_ptr() % 16 or weight_q.data_ptr() % 16):
        raise ValueError("int8_conv needs contiguous, 16-byte aligned tensors "
                         "on one device")
    ho = _conv_out(h, k, stride, padding, dilation)
    wo = _conv_out(w, k, stride, padding, dilation)
    if min(ho, wo, n, cout) < 1 or n * ho * wo >= 2 ** 31 // 128:
        raise ValueError(f"unsupported int8_conv shape {tuple(x.shape)} -> "
                         f"({n}, {ho}, {wo}, {cout})")
    return n, h, w, cin, cout, k, ho, wo


def int8_conv(x: torch.Tensor, weight_q: torch.Tensor, bias: torch.Tensor,
              w_scale: torch.Tensor, a_scale: torch.Tensor, stride: int = 1,
              padding: int = 0, dilation: int = 1, relu: bool = False,
              out_dtype=None, a_next=None) -> torch.Tensor:
    """``int8_conv_plain`` on the CPU; on the card the kernel
    ``int8_conv_route`` names for the call (csrc/int8_conv.cu): contiguous
    NHWC activations (float32 or bfloat16; or int8 on the wgmma route), a
    contiguous (Cout, kh, kw, Cin) int8 kernel, a contiguous (N, Ho, Wo,
    Cout) output in ``out_dtype``, or int8 with ``a_next`` (wgmma route
    only). A float input on the wgmma route is quantized first by one
    ``int8_quantize`` launch (counted there), made from the same call."""
    if x.device.type == "cpu":
        return int8_conv_plain(x, weight_q, bias, w_scale, a_scale, stride,
                               padding, dilation, relu, out_dtype, a_next)
    n, h, w, cin, cout, k, ho, wo = _conv_checks(
        x, weight_q, bias, w_scale, a_scale, stride, padding, dilation, a_next)
    dt = _out_dtype(x, out_dtype)
    int8_io = x.dtype == torch.int8 or a_next is not None
    if int8_conv_route(cin, stride, h, w, cout, k, int8_io) == "mma_sync":
        if int8_io:
            raise ValueError(f"int8_conv at Cin {cin}, stride {stride} takes the "
                             "mma_sync route: float input and output only")
        return int8_conv_mma_sync(x, weight_q, bias, w_scale, a_scale, stride,
                                  padding, dilation, relu)
    # a float input is quantized by an int8_quantize launch made from the
    # same call, into a scratch tensor (one trip through ctypes)
    quantize = x.dtype != torch.int8
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device) if quantize else x
    out = torch.empty((n, ho, wo, cout), device=x.device,
                      dtype=dt if a_next is None else torch.int8)
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.ibp_int8_conv_wgmma(
            x.data_ptr() if quantize else None, int(x.dtype == torch.bfloat16),
            xq.data_ptr(), weight_q.data_ptr(), bias.data_ptr(), w_scale.data_ptr(),
            a_scale.data_ptr(), None if a_next is None else a_next.data_ptr(),
            out.data_ptr(), n, h, w, cin, cout, k, padding, dilation, ho, wo,
            int(relu), int(dt == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"int8_conv (wgmma) launch failed: error {err}")
    if quantize:
        _count(int8_quantize)
    _count(int8_conv, "wgmma")
    return out


def int8_conv_mma_sync(x: torch.Tensor, weight_q: torch.Tensor, bias: torch.Tensor,
                       w_scale: torch.Tensor, a_scale: torch.Tensor,
                       stride: int = 1, padding: int = 0, dilation: int = 1,
                       relu: bool = False) -> torch.Tensor:
    """The mma.sync kernel at any shape, float in and out (CUDA only).
    ``int8_conv`` calls it where ``int8_conv_route`` says "mma_sync";
    chip_smoke.py and the probe also time it beside the wgmma route."""
    n, h, w, cin, cout, k, ho, wo = _conv_checks(
        x, weight_q, bias, w_scale, a_scale, stride, padding, dilation, None)
    if x.dtype == torch.int8:
        raise ValueError("the mma_sync kernel takes float activations")
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
    _count(int8_conv, "mma_sync")
    return out


int8_conv.launches = 0
int8_conv.launches_by_route = {"wgmma": 0, "mma_sync": 0}
