// Heatmap non-maximum suppression for Hopper (sm_90a).
//
// Replaces the TPU kernel improved_body_parts_tpu/ops/pallas_kernels.py
// nms_pallas (_make_nms_kernel). Per (H, W) map: the neighbour max with
// -inf outside the map, over 4 neighbours ("plus") or 8 ("square"); keep x
// where x >= max and (x > thre for plus, x >= thre for square), else 0.
//
// Bound: device-memory bytes. Each pixel is read once and written once
// (at B=8 on the main path: 144 maps of 128x128 fp32, 9.4 MB each way); the
// neighbour reads hit L1/L2. One thread per output pixel, 32x8 blocks so a
// warp reads 128 contiguous bytes of a row; no shared memory, no
// synchronisation. Pure compares: bit-identical to the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

template <bool PLUS>
__global__ void nms_kernel(const float* __restrict__ heat,
                           float* __restrict__ out, int h, int w,
                           float thre) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const float* m = heat + static_cast<size_t>(blockIdx.z) * h * w;
  const float v = m[y * w + x];
  float mx = v;
  if (PLUS) {
    if (y > 0) mx = fmaxf(mx, m[(y - 1) * w + x]);
    if (y < h - 1) mx = fmaxf(mx, m[(y + 1) * w + x]);
    if (x > 0) mx = fmaxf(mx, m[y * w + x - 1]);
    if (x < w - 1) mx = fmaxf(mx, m[y * w + x + 1]);
  } else {
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int yy = y + dy, xx = x + dx;
        if ((dy || dx) && yy >= 0 && yy < h && xx >= 0 && xx < w)
          mx = fmaxf(mx, m[yy * w + xx]);
      }
    }
  }
  const bool keep = v >= mx && (PLUS ? v > thre : v >= thre);
  out[static_cast<size_t>(blockIdx.z) * h * w + y * w + x] = keep ? v : 0.0f;
}

}  // namespace

// heat, out: (n, h, w) fp32, contiguous, on the device. Launches on
// `stream`; returns cudaGetLastError() as an int (0 = launched).
extern "C" int ibp_nms(const float* heat, float* out, int n, int h, int w,
                       float thre, int plus, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plus)
    nms_kernel<true><<<grid, block, 0, s>>>(heat, out, h, w, thre);
  else
    nms_kernel<false><<<grid, block, 0, s>>>(heat, out, h, w, thre);
  return static_cast<int>(cudaGetLastError());
}
