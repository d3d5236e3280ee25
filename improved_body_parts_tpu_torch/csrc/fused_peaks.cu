// Fused NMS -> top-P -> patch extraction for Hopper (sm_90a), in one
// streaming pass with no NMS map in memory.
//
// Replaces the TPU kernel improved_body_parts_tpu/ops/pallas_kernels.py
// fused_peaks_pallas (_make_fused_peaks_kernel). Per (h, w) channel:
// scores (P,), yx (P, 2), n_raw and the (2*win+1)^2 patch of the input map
// around each pick (zeros outside the map), bit for bit the plain version
// (ops/kernels.py fused_peaks_plain: NMS, then P rounds of arg-max over the
// NMS map, each zeroing its cell, ties to the lowest flat index).
//
// Bound: device-memory bytes. Each map is read once and the outputs are
// small: (144, 128, 128) moves 9.44 MB in + 0.52 MB out, 2.97 us at
// 3.35 TB/s; (18, 272, 480) 9.40 MB + 0.06 MB, 2.83 us.
//
// The TPU design kept the NMS map in VMEM and ran P arg-max rounds over it.
// Carried over, that cost P full rescans of the map a channel, two block
// barriers a round, and a global scratch for maps beyond shared memory.
// Here instead:
//   * One pass. Each warp takes chunks of one row, kCells * 32 cells at a
//     time (coalesced loads, all issued at once; the neighbours come
//     through L1), applies the plus/square NMS on the fly and counts kept
//     cells for n_raw. A kept cell with value > 0 becomes a 64-bit key:
//     order-preserving float bits (-0 folded to +0), then ~flat_index, so a
//     larger key is a larger value, and on ties the lower index.
//   * Top-P lists. Each warp keeps the best keys it has seen as a sorted
//     list of R = ceil(min(P, h*w) / 32) rows of 32 keys: row 0 in a
//     register, one key a lane (all of it for P <= 32), the other rows in
//     shared memory. A key passes when it beats the list's rank-(P-1) key
//     and the block's floor (below); it waits in one of its lane's two
//     pending slots. When a lane would need a third, the warp sorts both
//     pending rows with a shuffle bitonic network and merges them into the
//     list (`flush`). After the first chunks of a noisy map few keys pass.
//   * The floor: the lowest of every warp's ceil(P / warps)-th best key,
//     and the best P-th key of any warp; either certifies P keys above it,
//     so a key below it is dropped before it costs a merge.
//   * The warps' lists are merged pairwise in shared memory (a tree), then,
//     where a channel is split over a thread-block cluster, the blocks'
//     lists the same way through distributed shared memory; one launch.
//   * Large maps fill the card: where one block a channel would leave SMs
//     idle, a channel is split by rows over a cluster of 2, 4 or 8 blocks
//     (launched with cudaLaunchKernelEx). The size doubles while k * size
//     stays within the SM count (the 256-thread blocks run several to an
//     SM, so every block stays resident), each block keeps at least 4096
//     cells and 1 row, and the lists fit in 48 KB: 8 at (18, 272, 480) and
//     (18, 256, 256), 1 (no cluster) at (144, 128, 128).
//   * The rule the P rounds reduce to, applied by the cluster's leader
//     block: the picks are the kept cells with value > 0 in key order; if
//     fewer than P exist, every remaining slot is Z, the lowest index whose
//     NMS value is 0 once the picks are zeroed (the lowest cell not kept or
//     kept holding +-0, or the lowest pick), with score 0; if no such cell
//     exists (every cell kept and negative, only with thre < 0), the next
//     slot is the best negative key with its value and every later slot
//     that cell with score 0.
// What holds it back (PERF.md, tools/probe_fused_peaks.py): the launch as
// CUDA events see it; the stream (8 warps a channel: about 9 warps an SM
// at (144, 128, 128), where 12 SMs hold two of the 144 blocks); and the
// flushes. More warps a channel stream a little faster but fill more lists.
// Pure compares and copies: bit-identical to the plain PyTorch version.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kCells = 4;  // cells a lane loads at once
constexpr int kMaxCluster = 8;
constexpr int kMinCellsPerBlock = 4096;
constexpr size_t kListBytes = 200 * 1024;  // dynamic shared memory for lists
constexpr size_t kClusterListBytes = 48 * 1024;

__device__ __forceinline__ u64 make_key(float v, int idx) {
  v = v + 0.0f;  // -0 -> +0: the two compare equal, as in the reference
  unsigned int b = __float_as_uint(v);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);  // monotone in v
  return (static_cast<u64>(b) << 32) | static_cast<unsigned int>(~idx);
}

__device__ __forceinline__ int key_index(u64 key) {
  return static_cast<int>(~static_cast<unsigned int>(key));
}

__device__ __forceinline__ u64 kmax(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 kmin(u64 a, u64 b) { return a < b ? a : b; }

// 32 keys, one a lane -> sorted descending by lane (bitonic sort).
__device__ __forceinline__ u64 warp_sort_desc(u64 x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const u64 o = __shfl_xor_sync(kFull, x, j);
      const bool lower = (lane & j) == 0;
      const bool desc = (lane & k) == 0;  // k == 32: the whole warp
      x = (lower == desc) ? kmax(x, o) : kmin(x, o);
    }
  }
  return x;
}

// A bitonic sequence of 32 keys -> sorted descending by lane.
__device__ __forceinline__ u64 warp_merge_desc(u64 x, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const u64 o = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) == 0 ? kmax(x, o) : kmin(x, o);
  }
  return x;
}

// Merge the sorted-descending batch `b` into a list of R rows in rank order
// (row r, lane l = rank 32 r + l): row 0 in `head`, rows >= 1 in `rows`.
// Each row takes the top 32 of itself and what came down from above; the
// other 32 go on to the next row (keys of rank >= 32 R drop out).
__device__ __forceinline__ void cascade(u64 b, u64& head, u64* rows, int R,
                                        int lane) {
  u64 br = __shfl_sync(kFull, b, 31 - lane);
  u64 lo = kmin(head, br);
  head = warp_merge_desc(kmax(head, br), lane);
  for (int r = 1; r < R; ++r) {
    if (!__any_sync(kFull, lo != 0)) break;
    b = warp_merge_desc(lo, lane);
    const u64 row = rows[r * 32 + lane];
    br = __shfl_sync(kFull, b, 31 - lane);
    lo = kmin(row, br);
    rows[r * 32 + lane] = warp_merge_desc(kmax(row, br), lane);
  }
  __syncwarp();
}

// Merge a lane's two waiting keys (0 = none) into the list: both rows
// sorted at once, then their top 32 (for R > 1 the other 32 too); returns
// the new row 0. Not inlined: one copy of its ~1,000 instructions stays in
// the instruction cache, where an inlined copy in each unrolled step of
// the stream would be fetched anew at each rare call.
__device__ __noinline__ u64 flush(u64 p0, u64 p1, u64 head, u64* rows, int R,
                                  int lane) {
  const u64 a = warp_sort_desc(p0, lane);
  const u64 br = __shfl_sync(kFull, warp_sort_desc(p1, lane), 31 - lane);
  cascade(warp_merge_desc(kmax(a, br), lane), head, rows, R, lane);
  if (R > 1) cascade(warp_merge_desc(kmin(a, br), lane), head, rows, R, lane);
  return head;
}

// The rank-q key of a list (0 where the list is shorter); all lanes call it.
__device__ __forceinline__ u64 list_key(u64 head, const u64* rows, int q,
                                        int R) {
  if (q >= 32 * R) return 0;
  if (q < 32) return __shfl_sync(kFull, head, q);
  return rows[q];
}

// Merge the list at `src` (R rows in rank order, in this block's or a
// cluster peer's shared memory) into the list at `dst`; one warp.
__device__ __forceinline__ void merge_list(u64* dst, const u64* src, int R,
                                           int P, int lane) {
  u64 head = dst[lane];
  for (int q = 0; q < R; ++q) {
    const u64 b = src[q * 32 + lane];
    const u64 top = __shfl_sync(kFull, b, 0);
    if (top == 0 || top <= list_key(head, dst, P - 1, R)) break;
    cascade(b, head, dst, R, lane);
  }
  dst[lane] = head;
  __syncwarp();
}

struct Totals {
  int count;           // kept cells (n_raw)
  int npos;            // kept cells with value > 0
  int zmin;            // lowest cell not kept or kept holding +-0
  int minpick;         // lowest index among the picks
  unsigned floor_hi;   // high word of the best rank-(P-1) key of any warp
  u64 neg;             // best key of a kept cell with value < 0
};

template <bool PLUS>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
fused_peaks_kernel(const float* __restrict__ heat, float* __restrict__ scores,
                   int* __restrict__ yx, int* __restrict__ n_raw,
                   float* __restrict__ patches, int h, int w, int max_peaks,
                   int win, float thre, int R) {
  extern __shared__ u64 lists[];  // one list of R rows a warp
  __shared__ Totals tot;
  __shared__ unsigned cert_hi[kMaxWarps];  // see floor_key below
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x / cs;
  const int hw = h * w;
  const int P = max_peaks;
  const float* m = heat + static_cast<size_t>(c) * hw;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  u64* mine = lists + static_cast<size_t>(warp) * R * 32;

  if (threadIdx.x == 0) tot = Totals{0, 0, INT_MAX, INT_MAX, 0u, 0ull};
  if (threadIdx.x < kMaxWarps) cert_hi[threadIdx.x] = 0u;
  for (int e = threadIdx.x; e < nwarps * R * 32; e += blockDim.x) lists[e] = 0;
  __syncthreads();

  // this block's rows of the channel; a warp takes a chunk of 32 * kCells
  // cells of one row at a time (each lane kCells cells 32 apart), all their
  // loads issued at once
  const int row0 = static_cast<int>(static_cast<long long>(rank) * h / cs);
  const int row1 = static_cast<int>(static_cast<long long>(rank + 1) * h / cs);
  const int chunks = (w + 32 * kCells - 1) / (32 * kCells);
  const int items = (row1 - row0) * chunks;
  u64 head = 0, pend0 = 0, pend1 = 0, thresh = 0, neg = 0;
  int count = 0, npos = 0, zmin = INT_MAX;
  const int kcert = (P + nwarps - 1) / nwarps;
  for (int item = warp; item < items; item += nwarps) {
    const int y = row0 + item / chunks;
    const int x0 = (item - (y - row0) * chunks) * 32 * kCells;
    const float* row = m + static_cast<size_t>(y) * w;
    const bool up = y > 0, down = y < h - 1;
    float v[kCells], mx[kCells];
#pragma unroll
    for (int u = 0; u < kCells; ++u) {
      const int x = x0 + u * 32 + lane;
      const bool in = x < w;
      v[u] = in ? row[x] : 0.0f;
      mx[u] = v[u];
      if (PLUS) {
        if (in && up) mx[u] = fmaxf(mx[u], row[x - w]);
        if (in && down) mx[u] = fmaxf(mx[u], row[x + w]);
        if (in && x > 0) mx[u] = fmaxf(mx[u], row[x - 1]);
        if (in && x < w - 1) mx[u] = fmaxf(mx[u], row[x + 1]);
      } else {
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx) {
            const bool row_in = dy < 0 ? up : (dy > 0 ? down : true);
            if (in && (dy || dx) && row_in && x + dx >= 0 && x + dx < w)
              mx[u] = fmaxf(mx[u], row[dy * w + x + dx]);
          }
        }
      }
    }
    // The floor: a key whose high word is below it has P keys above it.
    // Two certificates: another warp's rank-(P-1) key (tot.floor_hi), and
    // the lowest of every warp's rank-(kcert-1) key, kcert * nwarps >= P
    // keys in all. High words only, so a racing read is never torn.
    unsigned cert = lane < nwarps
        ? *reinterpret_cast<volatile unsigned*>(&cert_hi[lane]) : ~0u;
    cert = max(__reduce_min_sync(kFull, cert),
               *reinterpret_cast<volatile unsigned*>(&tot.floor_hi));
    const u64 floor_key = static_cast<u64>(cert) << 32;
#pragma unroll
    for (int u = 0; u < kCells; ++u) {
      const int x = x0 + u * 32 + lane;
      const int i = y * w + x;
      const bool keep =
          x < w && v[u] >= mx[u] && (PLUS ? v[u] > thre : v[u] >= thre);
      const u64 k = make_key(v[u], i);
      const u64 key = keep && v[u] > 0.0f ? k : 0;
      count += keep;
      npos += key != 0;
      if (x < w && (!keep || v[u] == 0.0f)) zmin = min(zmin, i);
      if (keep && v[u] < 0.0f) neg = kmax(neg, k);
      bool pass = key > thresh && key >= floor_key;
      if (__any_sync(kFull, pass && pend1 != 0)) {  // a lane needs a 3rd slot
        head = flush(pend0, pend1, head, mine, R, lane);
        pend0 = pend1 = 0;
        thresh = list_key(head, mine, P - 1, R);
        const u64 mine_cert = list_key(head, mine, kcert - 1, R);
        if (lane == 0) {
          cert_hi[warp] = static_cast<unsigned>(mine_cert >> 32);
          if (thresh != 0)
            atomicMax(&tot.floor_hi, static_cast<unsigned>(thresh >> 32));
        }
        pass = key > thresh && key >= floor_key;
      }
      if (pass) (pend0 == 0 ? pend0 : pend1) = key;
    }
  }
  if (__any_sync(kFull, pend0 != 0))
    head = flush(pend0, pend1, head, mine, R, lane);
  mine[lane] = head;

  count = __reduce_add_sync(kFull, count);
  npos = __reduce_add_sync(kFull, npos);
  zmin = __reduce_min_sync(kFull, zmin);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    neg = kmax(neg, __shfl_xor_sync(kFull, neg, o));
  if (lane == 0) {
    atomicAdd(&tot.count, count);
    atomicAdd(&tot.npos, npos);
    atomicMin(&tot.zmin, zmin);
    atomicMax(&tot.neg, neg);
  }
  __syncthreads();

  // the warps' lists, pairwise into warp 0's
  for (int s = 1; s < nwarps; s <<= 1) {
    if ((warp & (2 * s - 1)) == 0 && warp + s < nwarps)
      merge_list(mine, lists + static_cast<size_t>(warp + s) * R * 32, R, P,
                 lane);
    __syncthreads();
  }
  // the cluster's blocks, pairwise into the leader's (rank 0)
  if (cs > 1) cluster.sync();
  for (int s = 1; s < cs; s <<= 1) {
    if ((rank & (2 * s - 1)) == 0 && rank + s < cs && warp == 0)
      merge_list(lists, cluster.map_shared_rank(lists, rank + s), R, P, lane);
    cluster.sync();
  }
  if (rank == 0 && threadIdx.x == 0) {
    for (int r = 1; r < cs; ++r) {
      const Totals* o = cluster.map_shared_rank(&tot, r);
      tot.count += o->count;
      tot.npos += o->npos;
      tot.zmin = min(tot.zmin, o->zmin);
      tot.neg = kmax(tot.neg, o->neg);
    }
  }
  if (cs > 1) {
    cluster.sync();  // peers may exit: the leader has read their lists
    if (rank != 0) return;
  }

  const int npick = min(tot.npos, P);
  for (int k = threadIdx.x; k < npick; k += blockDim.x)
    atomicMin(&tot.minpick, key_index(lists[k]));
  __syncthreads();
  const int z = min(tot.zmin, tot.minpick);   // INT_MAX: no cell holds 0
  const int fill = z != INT_MAX ? z : key_index(tot.neg);
  const size_t slot0 = static_cast<size_t>(c) * P;
  if (threadIdx.x == 0) n_raw[c] = tot.count;
  for (int k = threadIdx.x; k < P; k += blockDim.x) {
    const int idx = k < npick ? key_index(lists[k]) : fill;
    const bool scored = k < npick || (z == INT_MAX && k == 0);
    scores[slot0 + k] = scored ? m[idx] : 0.0f;
    yx[2 * (slot0 + k)] = idx / w;
    yx[2 * (slot0 + k) + 1] = idx % w;
  }
  const int size = 2 * win + 1, taps = size * size;
  for (size_t e = threadIdx.x; e < static_cast<size_t>(P) * taps;
       e += blockDim.x) {
    const int k = static_cast<int>(e / taps);
    const int t = static_cast<int>(e - static_cast<size_t>(k) * taps);
    const int idx = k < npick ? key_index(lists[k]) : fill;
    const int cy = idx / w, cx = idx - cy * w;
    const int yy = cy + t / size - win, xx = cx + t % size - win;
    const bool inb = yy >= 0 && yy < h && xx >= 0 && xx < w;
    patches[slot0 * taps + e] = inb ? m[yy * w + xx] : 0.0f;
  }
}

template <bool PLUS>
int launch(const float* heat, float* scores, int* yx, int* n_raw,
           float* patches, int k, int h, int w, int max_peaks, int win,
           float thre, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long hw = static_cast<long long>(h) * w;
  const long long keys = max_peaks < hw ? max_peaks : hw;
  const int R = static_cast<int>((keys + 31) / 32);
  int nwarps = kMaxWarps;
  while (nwarps > 1 && static_cast<size_t>(nwarps) * R * 256 > kListBytes)
    nwarps >>= 1;
  const size_t smem = static_cast<size_t>(nwarps) * R * 256;
  if (smem > kListBytes) return static_cast<int>(cudaErrorInvalidValue);
  int cs = 1;
  while (cs < kMaxCluster && static_cast<long long>(k) * cs <= sms &&
         2 * cs <= h && hw / (2 * cs) >= kMinCellsPerBlock &&
         smem <= kClusterListBytes)
    cs *= 2;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_peaks_kernel<PLUS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(k) * cs);
  cfg.blockDim = dim3(nwarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;  // one block a channel: no cluster
  err = cudaLaunchKernelEx(&cfg, fused_peaks_kernel<PLUS>, heat, scores, yx,
                           n_raw, patches, h, w, max_peaks, win, thre, R);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// heat (k, h, w) fp32 -> scores (k, P) fp32, yx (k, P, 2) int32,
// n_raw (k,) int32, patches (k, P, 2*win+1, 2*win+1) fp32; all contiguous
// on the device. Launches on `stream`; returns the CUDA error as an int
// (cudaErrorInvalidValue when min(P, h*w) keys exceed the lists' shared
// memory, ibp_fused_peaks_max_list_keys()).
extern "C" int ibp_fused_peaks(const float* heat, float* scores, int* yx,
                               int* n_raw, float* patches, int k, int h, int w,
                               int max_peaks, int win, float thre, int plus,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return plus ? launch<true>(heat, scores, yx, n_raw, patches, k, h, w,
                             max_peaks, win, thre, s)
              : launch<false>(heat, scores, yx, n_raw, patches, k, h, w,
                              max_peaks, win, thre, s);
}

// The most keys a list may hold: min(max_peaks, h*w) must not exceed it.
extern "C" int ibp_fused_peaks_max_list_keys() {
  return static_cast<int>(kListBytes / 256) * 32;
}
