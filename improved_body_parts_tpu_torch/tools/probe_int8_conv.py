"""Where the time of the port's ``int8_conv`` kernel goes, on one GPU.

Builds ``improved_body_parts_tpu_torch/csrc/int8_conv.cu`` as it is and in
variants (each one text substitution of the source, compiled side by side
with nvcc into ``build/probe_int8_conv/``), and times each with CUDA events
(``chip_smoke.device_ms``, input warm in L2) at the conv shapes that take
most of a Canonical int8 ``predict_maps`` of 16 x 512² (chip_smoke.py phase
10), with random bf16 activations, an int8 kernel over the full range and
the scales of a calibrated layer. The kernel and ``fdiv`` are checked bit
for bit against ``int8_conv_plain``; the stripped variants compute wrong
outputs and are only timed.

    python3 -m improved_body_parts_tpu_torch.tools.probe_int8_conv

Variants:
  kernel    the kernel as it is
  fdiv      quantizes with the IEEE division on every element (no
            multiply-by-reciprocal fast path)
  no_quant  converts each activation to int8 with one cast (no division,
            no rounding, no clip): the cost of the quantization
  no_mma    replaces each mma.sync by an integer xor of its operands: the
            cost of everything but the tensor cores

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
FAST = ("  const float t = v * inv;\n  float q = rintf(t);\n"
        "  if (fabsf(fabsf(t - q) - 0.5f) < 0x1p-13f) q = rintf(__fdiv_rn(v, a_scale));\n")
MMA = ('  asm volatile(\n      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "\n'
       '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"\n'
       '      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])\n'
       '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));\n')
VARIANTS = {
    "kernel": [],
    "fdiv": [(FAST, "  float q = rintf(__fdiv_rn(v, a_scale));\n")],
    "no_quant": [(FAST, "  float q = static_cast<float>(static_cast<int>(v));\n")],
    "no_mma": [(MMA, "  c[0] ^= a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1;\n")],
}
EXACT = ("kernel", "fdiv")
# (N, H, W, Cin, Cout, k, stride, dilation): the largest shares of the
# int8 predict_maps' conv time, a 1x1, the dilated backbone, the stem and
# the 8x8 scale-4 map
SHAPES = ((16, 128, 128, 256, 256, 3, 1, 1), (16, 64, 64, 384, 384, 3, 1, 1),
          (16, 128, 128, 128, 128, 3, 1, 5), (16, 64, 64, 192, 384, 1, 1, 1),
          (16, 256, 256, 64, 64, 3, 1, 1), (16, 512, 512, 3, 64, 7, 2, 1),
          (16, 8, 8, 768, 256, 3, 1, 1))


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
        lib.ibp_int8_conv.argtypes = build._ARGTYPES["ibp_int8_conv"]
        libs[name] = lib
    return libs


def launch(lib, x, w, bias, w_scale, a_scale, stride, pad, dil, relu=True):
    n, h, wd, cin = x.shape
    cout, k = w.shape[0], w.shape[1]
    ho = (h + 2 * pad - dil * (k - 1) - 1) // stride + 1
    wo = (wd + 2 * pad - dil * (k - 1) - 1) // stride + 1
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    err = lib.ibp_int8_conv(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                            w_scale.data_ptr(), a_scale.data_ptr(), out.data_ptr(),
                            n, h, wd, cin, cout, k, k, stride, pad, dil, ho, wo,
                            int(relu), 1, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(build.BUILD_DIR)))
    import chip_smoke
    if not torch.cuda.is_available():
        print("probe_int8_conv: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    libs = build_variants()
    print(f"int8_conv variants, bf16 in and out, LeakyReLU, ms between CUDA "
          f"events (median of 10, input warm in L2; {smi})")
    g = torch.Generator().manual_seed(0)
    for n, h, wd, cin, cout, k, stride, dil in SHAPES:
        x = torch.randn((n, h, wd, cin), generator=g).bfloat16().cuda()
        w = torch.randint(-127, 128, (cout, k, k, cin), generator=g,
                          dtype=torch.int8).cuda()
        bias = (torch.randn(cout, generator=g) * 0.1).cuda()
        w_scale = (torch.rand(cout, generator=g) * 1e-3 + 1e-4).cuda()
        a_scale = (x.float().abs().max() / 127.0).reshape(())
        pad = dil * (k - 1) // 2
        args = (x, w, bias, w_scale, a_scale, stride, pad, dil)
        want = kernels.int8_conv_plain(*args, True)
        for name in EXACT:
            got = launch(libs[name], *args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} differs from the plain version")
        ho, wo = want.shape[1:3]
        ops = 2 * n * ho * wo * cout * cin * k * k
        row = []
        for name, lib in libs.items():
            ms = chip_smoke.device_ms(lambda: launch(lib, *args), runs=10)
            row.append(f"{name} {ms:.4f} ({ops / ms / 1e9:.0f} TOPS)")
        print(f"({n}, {h}, {wd}, {cin}) k{k} s{stride} d{dil} -> {cout}: "
              + "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
