"""Where the time of the port's int8 convolution goes, on one GPU.

Builds ``improved_body_parts_tpu_torch/csrc/int8_conv.cu`` as it is and in
variants (text substitutions of the source, compiled side by side with
nvcc into ``build/probe_int8_conv/``), and times the parts of the wgmma
route with CUDA events (``chip_smoke.device_ms``, input warm in L2) at the
conv shapes that take most of a Canonical int8 ``predict_maps`` of 16 x
512² (chip_smoke.py phase 10), with random bf16 activations, an int8 kernel
over the full range and the scales of a calibrated layer. The route and
both kernels are checked bit for bit against ``int8_conv_plain``; the
stripped variant computes wrong outputs and is only timed.

    python3 -m improved_body_parts_tpu_torch.tools.probe_int8_conv

Parts, bf16 in and out, LeakyReLU:
  quantize    the int8_quantize pass alone (bf16 -> int8)
  gemm        the wgmma kernel on the pre-quantized int8 input
  route       both, as int8_conv runs a bf16 input on the wgmma route
  no_wgmma    the wgmma kernel with each wgmma replaced by an integer xor
              of its descriptors: the cost of everything but the tensor
              cores (TMA loads, barriers, epilogue)
  bn128       the wgmma kernel with 128-column tiles where it takes 256
  deep_ring   the wgmma kernel with a ring of 8 stages for 256-column tiles
              and 6 for 128 (as many as shared memory holds) instead of 4
  one_block   the wgmma kernel with launch bounds of one block an SM (no
              register cap below 224)
  req         the wgmma kernel writing int8 quantized for a next conv (the
              fused links); tie_call_req and one_block_req the same in the
              variants tie_call (the IEEE division near a rounding tie as a
              call, not inlined), one_block and cvt_round
  cvt_round   quant() rounding with rint and a float-to-int conversion in
              place of the adds of 1.5 * 2^23 (also timed for the quantize
              pass and the mma_sync kernel, which share quant())
  mma_sync    the first design's kernel, which quantizes on load, at the
              same shape

Imports torch, the port and ``chip_smoke`` (its timing) only.
"""

import ctypes
import os
import subprocess
import sys

import torch

from improved_body_parts_tpu_torch.ops import build, kernels

SRC = os.path.join(build.CSRC_DIR, "int8_conv.cu")
OUT = os.path.join(os.path.dirname(build.BUILD_DIR), "probe_int8_conv")
WGMMA = "        wgmma_mma(acc, da + 2 * ks, db + 2 * ks);\n"
BN256 = ("  if (s.cout % 256 == 0 && s.k * s.k * s.cin >= 1024 &&\n"
         "      pixel_tiles * (s.cout / 256) >= 264) return 256;\n")
STAGES = "__host__ __device__ constexpr int wg_stages() { return 4; }\n"
QUANT = "__device__ __forceinline__ uint32_t quant(float v, float a_scale, float inv) {\n"
TIE = "    q = fminf(fmaxf(rintf(__fdiv_rn(v, a_scale)), -127.0f), 127.0f);\n"
BOUNDS = "__global__ void __launch_bounds__(WG_THREADS, BN == 256 ? 1 : BN == 128 ? 2 : 3)\n"
# the rounding of quant() by rint and a float-to-int conversion, as the
# mma.sync kernel first had it
ROUND = ("  float q = __fsub_rn(__fadd_rn(t, kRound), kRound);\n",
         "  float q = rintf(t);\n")
BYTE = ("  return __float_as_uint(__fadd_rn(q, kRound)) & 0xFFu;\n",
        "  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)));\n")
VARIANTS = {
    "kernel": [],
    "no_wgmma": [(WGMMA, "        acc[ks] ^= static_cast<int>(da ^ db);\n")],
    "bn128": [(BN256, "")],
    "deep_ring": [(STAGES, "__host__ __device__ constexpr int wg_stages() "
                           "{ return BN == 256 ? 8 : BN == 128 ? 6 : 4; }\n")],
    "tie_call": [(QUANT, "__device__ __noinline__ float quant_tie(float v, float a) "
                         "{ return rintf(__fdiv_rn(v, a)); }\n" + QUANT),
                 (TIE, "    q = fminf(fmaxf(quant_tie(v, a_scale), -127.0f), 127.0f);\n")],
    "one_block": [(BOUNDS, "__global__ void __launch_bounds__(WG_THREADS, 1)\n")],
    "cvt_round": [ROUND, BYTE],
}
# (N, H, W, Cin, Cout, k, stride, dilation): the largest shares of the
# int8 predict_maps' conv time, 1x1 convs (the narrow ones were slower
# than the mma.sync kernel in the first wgmma designs), the dilated
# backbone, the
# 256^2 residual, the 8x8 scale-4 map, and the stem (mma_sync route only)
SHAPES = ((16, 128, 128, 256, 256, 3, 1, 1), (16, 64, 64, 384, 384, 3, 1, 1),
          (16, 128, 128, 128, 128, 3, 1, 5), (16, 64, 64, 192, 384, 1, 1, 1),
          (16, 256, 256, 64, 64, 3, 1, 1), (16, 256, 256, 64, 128, 1, 1, 1),
          (16, 128, 128, 256, 128, 1, 1, 1), (16, 128, 128, 128, 256, 1, 1, 1),
          (16, 256, 256, 64, 64, 1, 1, 1), (16, 128, 128, 128, 64, 1, 1, 1),
          (16, 64, 64, 256, 50, 1, 1, 1),
          (16, 8, 8, 768, 256, 3, 1, 1), (16, 512, 512, 3, 64, 7, 2, 1))


def build_variants():
    os.makedirs(OUT, exist_ok=True)
    with open(SRC) as f:
        text = f.read()
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"variant {name}: {old!r} not in {SRC}")
            src = src.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             os.path.join(OUT, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        for fn in ("ibp_int8_conv", "ibp_int8_conv_wgmma", "ibp_int8_quantize"):
            getattr(lib, fn).argtypes = build._ARGTYPES[fn]
        libs[name] = lib
    return libs


def _check(err, what):
    if err:
        raise RuntimeError(f"{what} launch failed: error {err}")


def quantize(lib, x, a_scale):
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    _check(lib.ibp_int8_quantize(x.data_ptr(), out.data_ptr(), a_scale.data_ptr(),
                                 x.numel(), 1, torch.cuda.current_stream().cuda_stream),
           "int8_quantize")
    return out


def gemm(lib, xq, w, bias, w_scale, a_scale, pad, dil, relu=True, a_next=None):
    n, h, wd, cin = xq.shape
    cout, k = w.shape[0], w.shape[1]
    ho, wo = h + 2 * pad - dil * (k - 1), wd + 2 * pad - dil * (k - 1)
    out = torch.empty((n, ho, wo, cout), device=xq.device,
                      dtype=torch.bfloat16 if a_next is None else torch.int8)
    _check(lib.ibp_int8_conv_wgmma(
        None, 0, xq.data_ptr(), w.data_ptr(), bias.data_ptr(), w_scale.data_ptr(),
        a_scale.data_ptr(), None if a_next is None else a_next.data_ptr(),
        out.data_ptr(), n, h, wd, cin, cout, k, pad, dil, ho, wo, int(relu), 1,
        torch.cuda.current_stream().cuda_stream), "wgmma")
    return out


def mma_sync(lib, x, w, bias, w_scale, a_scale, stride, pad, dil, relu=True):
    n, h, wd, cin = x.shape
    cout, k = w.shape[0], w.shape[1]
    ho = (h + 2 * pad - dil * (k - 1) - 1) // stride + 1
    wo = (wd + 2 * pad - dil * (k - 1) - 1) // stride + 1
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    _check(lib.ibp_int8_conv(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                             w_scale.data_ptr(), a_scale.data_ptr(), out.data_ptr(),
                             n, h, wd, cin, cout, k, k, stride, pad, dil, ho, wo,
                             int(relu), 1, torch.cuda.current_stream().cuda_stream),
           "mma_sync")
    return out


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(build.BUILD_DIR)))
    import chip_smoke
    if not torch.cuda.is_available():
        print("probe_int8_conv: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    libs = build_variants()
    lib, bare = libs["kernel"], libs["no_wgmma"]
    print(f"int8 conv parts, bf16 in and out, LeakyReLU, ms between CUDA events "
          f"(median of 10, input warm in L2; {smi})")
    g = torch.Generator().manual_seed(0)
    for n, h, wd, cin, cout, k, stride, dil in SHAPES:
        x = torch.randn((n, h, wd, cin), generator=g).bfloat16().cuda()
        w = torch.randint(-127, 128, (cout, k, k, cin), generator=g,
                          dtype=torch.int8).cuda()
        bias = (torch.randn(cout, generator=g) * 0.1).cuda()
        w_scale = (torch.rand(cout, generator=g) * 1e-3 + 1e-4).cuda()
        a_scale = (x.float().abs().max() / 127.0).reshape(())
        pad = dil * (k - 1) // 2
        want = kernels.int8_conv_plain(x, w, bias, w_scale, a_scale, stride, pad, dil,
                                       True)
        old = mma_sync(lib, x, w, bias, w_scale, a_scale, stride, pad, dil)
        torch.cuda.synchronize()
        if not torch.equal(old, want):
            raise AssertionError("the mma_sync kernel differs from the plain version")
        ops = 2 * want[..., 0].numel() * cout * cin * k * k
        parts = {}
        if kernels.int8_conv_route(cin, stride) == "wgmma":
            xq = quantize(lib, x, a_scale)
            got = gemm(lib, xq, w, bias, w_scale, a_scale, pad, dil)
            torch.cuda.synchronize()
            if not (torch.equal(xq, kernels.int8_quantize_plain(x, a_scale))
                    and torch.equal(got, want)):
                raise AssertionError("the wgmma route differs from the plain version")
            parts["quantize"] = chip_smoke.device_ms(lambda: quantize(lib, x, a_scale),
                                                     runs=10)
            if not torch.equal(quantize(libs["cvt_round"], x, a_scale), xq):
                raise AssertionError("cvt_round's int8_quantize differs")
            parts["cvt_round_quantize"] = chip_smoke.device_ms(
                lambda: quantize(libs["cvt_round"], x, a_scale), runs=10)
            parts["gemm"] = chip_smoke.device_ms(
                lambda: gemm(lib, xq, w, bias, w_scale, a_scale, pad, dil), runs=10)
            parts["route"] = chip_smoke.device_ms(
                lambda: gemm(lib, quantize(lib, x, a_scale), w, bias, w_scale, a_scale,
                             pad, dil), runs=10)
            parts["no_wgmma"] = chip_smoke.device_ms(
                lambda: gemm(bare, xq, w, bias, w_scale, a_scale, pad, dil), runs=10)
            narrow = libs["bn128"]
            if not torch.equal(gemm(narrow, xq, w, bias, w_scale, a_scale, pad, dil), want):
                raise AssertionError("bn128 differs from the plain version")
            parts["bn128"] = chip_smoke.device_ms(
                lambda: gemm(narrow, xq, w, bias, w_scale, a_scale, pad, dil), runs=10)
            deep = libs["deep_ring"]
            parts["deep_ring"] = chip_smoke.device_ms(
                lambda: gemm(deep, xq, w, bias, w_scale, a_scale, pad, dil), runs=10)
            parts["one_block"] = chip_smoke.device_ms(
                lambda: gemm(libs["one_block"], xq, w, bias, w_scale, a_scale, pad, dil),
                runs=10)
            a_next = (want.float().abs().max() / 127.0).reshape(())
            want_q = kernels.int8_quantize_plain(want, a_next)
            for name in ("kernel", "tie_call", "one_block", "cvt_round"):
                lib_v = libs[name]
                got_q = gemm(lib_v, xq, w, bias, w_scale, a_scale, pad, dil, True, a_next)
                torch.cuda.synchronize()
                if not torch.equal(got_q, want_q):
                    raise AssertionError(f"{name}: int8 output differs from the plain version")
                parts["req" if name == "kernel" else f"{name}_req"] = chip_smoke.device_ms(
                    lambda: gemm(lib_v, xq, w, bias, w_scale, a_scale, pad, dil, True,
                                 a_next), runs=10)
        parts["mma_sync"] = chip_smoke.device_ms(
            lambda: mma_sync(lib, x, w, bias, w_scale, a_scale, stride, pad, dil),
            runs=10)
        parts["cvt_round_mma_sync"] = chip_smoke.device_ms(
            lambda: mma_sync(libs["cvt_round"], x, w, bias, w_scale, a_scale, stride,
                             pad, dil), runs=10)
        row = [f"{name} {ms:.4f}" + ("" if name in ("quantize", "cvt_round_quantize",
                                                   "no_wgmma")
                                     else f" ({ops / ms / 1e9:.0f} TOPS)")
               for name, ms in parts.items()]
        print(f"({n}, {h}, {wd}, {cin}) k{k} s{stride} d{dil} -> {cout}: "
              + "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
