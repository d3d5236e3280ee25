#!/usr/bin/env python3
"""Where the time of the port's ``fused_peaks`` kernel goes, on one GPU.

Builds ``improved_body_parts_tpu_torch/csrc/fused_peaks.cu`` as it is and in
stripped variants (each one text substitution of the source, compiled side
by side with nvcc into ``build/probe_fused_peaks/``), and times each with
CUDA events (``chip_smoke.device_ms``) on noise maps, the edge-case maps of
``chip_smoke.edge_maps`` and all-zero maps, at the main-path shape and at a
1088x1920 frame's. The stripped variants compute wrong tables; only the
full kernel is checked against the plain version.

    python3 tools/probe_fused_peaks.py

Variants:
  kernel     the kernel as it is
  empty      returns at once: the launch as CUDA events see it
  no_stream  streams no cell: launch, set-up, merges of empty lists, outputs
  no_flush   never merges a warp's pending keys into its list
  flushes    the kernel, counting its flushes into n_raw (printed per channel)

Imports torch and the port only.
"""

import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from improved_body_parts_tpu_torch.ops import build, kernels  # noqa: E402

SRC = os.path.join(REPO, "improved_body_parts_tpu_torch", "csrc", "fused_peaks.cu")
OUT = os.path.join(REPO, "build", "probe_fused_peaks")
FLUSH = "        head = flush(pend0, pend1, head, mine, R, lane);\n"
VARIANTS = {
    "kernel": [],
    "empty": [("  __shared__ Totals tot;\n",
               "  __shared__ Totals tot;\n  if (h > 0) return;\n")],
    "no_stream": [("  for (int item = warp; item < items; item += nwarps) {",
                   "  for (int item = warp; item < 0; item += nwarps) {"),
                  ("  const int fill = z != INT_MAX ? z : key_index(tot.neg);",
                   "  const int fill = 0;")],
    "no_flush": [("      if (__any_sync(kFull, pass && pend1 != 0)) {",
                  "      if (__any_sync(kFull, pass && pend1 != 0) && h < 0) {"),
                 ("  const int npick = min(tot.npos, P);", "  const int npick = 0;"),
                 ("  const int fill = z != INT_MAX ? z : key_index(tot.neg);",
                  "  const int fill = 0;")],
    "flushes": [("  if (threadIdx.x == 0) n_raw[c] = tot.count;\n", ""),
                (FLUSH, FLUSH + "        if (lane == 0) atomicAdd(n_raw + c, 1);\n")],
}
P, WIN, THRE = 32, 2, 0.1


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
        lib.ibp_fused_peaks.argtypes = build._ARGTYPES["ibp_fused_peaks"]
        libs[name] = lib
    return libs


def launch(lib, heat):
    k, h, w = heat.shape
    size = 2 * WIN + 1
    outs = (torch.empty((k, P), device=heat.device),
            torch.empty((k, P, 2), dtype=torch.int32, device=heat.device),
            torch.zeros((k,), dtype=torch.int32, device=heat.device),
            torch.empty((k, P, size, size), device=heat.device))
    err = lib.ibp_fused_peaks(heat.data_ptr(), *[o.data_ptr() for o in outs],
                              k, h, w, P, WIN, THRE, 1,
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return outs


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_fused_peaks: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    libs = build_variants()
    print(f"fused_peaks variants, P={P} plus win={WIN}, ms between CUDA events "
          f"(median of {chip_smoke.TIMING_RUNS}, input warm in L2; {smi})")
    for shape in ((144, 128, 128), (18, 272, 480)):
        g = torch.Generator().manual_seed(0)
        maps = (("noise", (torch.rand(shape, generator=g) * 0.6).cuda()),
                ("edge", chip_smoke.edge_maps(shape, "cuda")),
                ("zeros", torch.zeros(shape, device="cuda")))
        for map_name, heat in maps:
            want = kernels.fused_peaks_plain(heat, THRE, P, "plus", WIN)
            got = launch(libs["kernel"], heat)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"kernel differs from plain on {map_name}")
            row = [f"nms {chip_smoke.device_ms(lambda: kernels.nms(heat, THRE)):.5f}"]
            for name, lib in libs.items():
                ms = chip_smoke.device_ms(lambda: launch(lib, heat))
                row.append(f"{name} {ms:.5f}")
            n_flush = launch(libs["flushes"], heat)[2].float().mean().item()
            torch.cuda.synchronize()
            print(f"{shape} {map_name}: {'; '.join(row)}; flushes per channel "
                  f"{n_flush:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
