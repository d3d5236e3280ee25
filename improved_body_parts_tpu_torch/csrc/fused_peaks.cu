// Fused NMS -> top-P -> 5x5 patch extraction for Hopper (sm_90a).
//
// Replaces the TPU kernel improved_body_parts_tpu/ops/pallas_kernels.py
// fused_peaks_pallas (_make_fused_peaks_kernel). Per channel, in one pass:
//   * NMS as in nms.cu, written into the block's NMS map; n_raw = the number
//     of cells kept (a block reduction);
//   * P rounds of masked arg-max over the NMS map: the highest score, and on
//     ties the lowest flat index, exactly the Pallas kernel's
//     max -> (== max) -> min index. Each round records the score, (y, x)
//     and the (2*win+1)^2 patch of the ORIGINAL map around the peak (zeros
//     outside the map), then zeroes that cell. Once the map is exhausted
//     every later round picks cell 0 (the lowest index holding 0), exactly
//     as the Pallas kernel does.
//
// Where the NMS map lives:
//   * in shared memory when h*w fp32 fits one block (64 KB at 128x128, so
//     the kernel opts in to more than 48 KB of dynamic shared memory);
//   * otherwise in a global scratch of (k, h, w) fp32 that the wrapper
//     allocates (e.g. 510 KB a channel at 272x480, a 1088x1920 frame). Each
//     block reads and writes only its own channel's slice, and the block
//     barriers that order the rounds also order those global accesses; the
//     scratch of a few MB stays in the 50 MB L2 across the P rounds.
//
// Bound: device-memory bytes (the map is read once from global memory; the
// P rounds run out of shared memory or L2) and, at P = 32, the 2 block
// barriers a round costs. One block per channel: 144 blocks at B=8, about
// one wave on 132 SMs. The arg-max of a round is one reduction over 64-bit
// keys (order-preserving float bits << 32 | ~flat_index), so the highest key
// is the highest score with the lowest index; the patch is read straight
// from global memory, so no one-hot contractions are needed. Pure compares
// and copies: bit-identical to the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ unsigned long long make_key(float v, int idx) {
  v = v + 0.0f;  // -0 -> +0: the two compare equal, as in the reference
  unsigned int b = __float_as_uint(v);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);  // monotone in v
  return (static_cast<unsigned long long>(b) << 32) |
         static_cast<unsigned int>(~idx);
}

// SMEM: the NMS map in dynamic shared memory; else in scratch + c*h*w.
template <bool PLUS, bool SMEM>
__global__ void __launch_bounds__(kThreads)
fused_peaks_kernel(const float* __restrict__ heat, float* __restrict__ scratch,
                   float* __restrict__ scores, int* __restrict__ yx,
                   int* __restrict__ n_raw, float* __restrict__ patches, int h,
                   int w, int max_peaks, int win, float thre) {
  extern __shared__ float smem_nm[];
  __shared__ unsigned long long warp_best[kWarps];
  __shared__ int warp_count[kWarps];

  const int c = blockIdx.x;
  const int hw = h * w;
  const float* m = heat + static_cast<size_t>(c) * hw;
  float* nm = SMEM ? smem_nm : scratch + static_cast<size_t>(c) * hw;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int count = 0;
  for (int i = threadIdx.x; i < hw; i += kThreads) {
    const int y = i / w, x = i - y * w;
    const float v = m[i];
    float mx = v;
    if (PLUS) {
      if (y > 0) mx = fmaxf(mx, m[i - w]);
      if (y < h - 1) mx = fmaxf(mx, m[i + w]);
      if (x > 0) mx = fmaxf(mx, m[i - 1]);
      if (x < w - 1) mx = fmaxf(mx, m[i + 1]);
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
    nm[i] = keep ? v : 0.0f;
    count += keep;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    count += __shfl_xor_sync(0xffffffffu, count, o);
  if (lane == 0) warp_count[warp] = count;
  __syncthreads();  // NMS map and counts complete
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < kWarps; ++i) total += warp_count[i];
    n_raw[c] = total;
  }

  const int size = 2 * win + 1;
  for (int k = 0; k < max_peaks; ++k) {
    unsigned long long best = 0;
    for (int i = threadIdx.x; i < hw; i += kThreads) {
      const unsigned long long key = make_key(nm[i], i);
      best = key > best ? key : best;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, o);
      best = other > best ? other : best;
    }
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();  // partials written; scans of nm finished
    best = warp_best[0];
    for (int i = 1; i < kWarps; ++i)
      best = warp_best[i] > best ? warp_best[i] : best;
    const int idx = static_cast<int>(~static_cast<unsigned int>(best));
    const int cy = idx / w, cx = idx - cy * w;
    const size_t slot = static_cast<size_t>(c) * max_peaks + k;
    if (threadIdx.x < size * size) {
      const int yy = cy + static_cast<int>(threadIdx.x) / size - win;
      const int xx = cx + static_cast<int>(threadIdx.x) % size - win;
      const bool inb = yy >= 0 && yy < h && xx >= 0 && xx < w;
      patches[slot * size * size + threadIdx.x] = inb ? m[yy * w + xx] : 0.0f;
    }
    if (threadIdx.x == 0) {
      scores[slot] = nm[idx];
      yx[2 * slot] = cy;
      yx[2 * slot + 1] = cx;
      nm[idx] = 0.0f;
    }
    __syncthreads();  // partials read and the cell zeroed before the next scan
  }
}

template <bool PLUS, bool SMEM>
int launch(const float* heat, float* scratch, float* scores, int* yx,
           int* n_raw, float* patches, int k, int h, int w, int max_peaks,
           int win, float thre, cudaStream_t stream) {
  const int smem = SMEM ? h * w * static_cast<int>(sizeof(float)) : 0;
  if (SMEM) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_peaks_kernel<PLUS, SMEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_peaks_kernel<PLUS, SMEM><<<k, kThreads, smem, stream>>>(
      heat, scratch, scores, yx, n_raw, patches, h, w, max_peaks, win, thre);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// heat (k, h, w) fp32 -> scores (k, P) fp32, yx (k, P, 2) int32,
// n_raw (k,) int32, patches (k, P, 2*win+1, 2*win+1) fp32; all contiguous
// on the device. `scratch` is null (NMS map in shared memory) or a (k, h, w)
// fp32 buffer for maps beyond one block's shared memory. Launches on
// `stream`; returns the CUDA error as an int.
extern "C" int ibp_fused_peaks(const float* heat, float* scratch,
                               float* scores, int* yx, int* n_raw,
                               float* patches, int k, int h, int w,
                               int max_peaks, int win, float thre, int plus,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch == nullptr)
    return plus ? launch<true, true>(heat, scratch, scores, yx, n_raw, patches,
                                     k, h, w, max_peaks, win, thre, s)
                : launch<false, true>(heat, scratch, scores, yx, n_raw,
                                      patches, k, h, w, max_peaks, win, thre, s);
  return plus ? launch<true, false>(heat, scratch, scores, yx, n_raw, patches,
                                    k, h, w, max_peaks, win, thre, s)
              : launch<false, false>(heat, scratch, scores, yx, n_raw, patches,
                                     k, h, w, max_peaks, win, thre, s);
}
