// int8 convolution for Hopper (sm_90a), and the activation quantization
// that feeds it.
//
// Replaces XLA's int8 convolution of the JAX package's int8 forward,
// improved_body_parts_tpu/models/imhn.py ConvBlock(quant="int8") (:78-99):
// the quantization of the block's input (:87-88) and
// lax.conv_general_dilated(..., preferred_element_type=int32) (:89-95)
// with its epilogue (:96-98). It computes exactly what that block
// computes, in its operation order:
//   xq  = clip(rint(x_f32 / a_scale), -127, 127)     (IEEE division, ties
//                                                      to even)
//   acc = sum over (ky, kx, ci) of xq * wq           (int32, exact)
//   y   = acc_f32 * (a_scale * w_scale[o]) + bias[o] (no FMA contraction)
//   y   = LeakyReLU_0.01(cast(y, T)), in T's arithmetic, where the block
//         has one.
// Activations are NHWC (T = float or bf16), weights (Cout, kh, kw, Cin)
// int8, so the reduction index k = (ky * kw + kx) * Cin + ci is contiguous
// in both operands. Zero padding is applied to the quantized operand (0
// quantizes to 0). |acc| <= 127^2 * K; the model's largest K is 6,912
// (3x3 on 768 channels), so no sum comes near 2^31.
//
// Bound: a Canonical int8 predict_maps of 16 x 512^2 runs 296 convs in 72
// shapes, 8.19 T int8 operations (89% of them in the 108 3x3 convs): ~4 ms
// of tensor-core work at 1,979 TOPS, and ~16 GB of bf16 activations in and
// out, ~4.8 ms at 3.35 TB/s. The first design (the mma.sync kernel below) ran
// at 0.096 of that bound, held back by its operand path: each bf16
// activation was gathered through L2 per thread and quantized again for
// each of the 9 taps and each 128-column block of outputs. The design below
// is held back by its loads instead: with each wgmma replaced by a no-op
// (tools/probe_int8_conv) a 3x3 conv on 256 channels keeps most of its
// time, the operand tiles streaming from L2 (each activation tile is read
// for each of the 9 taps and each column block, each weight tile for each
// pixel tile); a 1x1 conv is bound by its output bytes and epilogue.
//
// The design:
//   1. Quantize each activation once. int8_quantize_kernel turns a bf16 or
//      fp32 NHWC tensor into int8 in one streaming pass (bytes-bound), with
//      the same quant() as the convolution used to apply on load. A conv
//      whose output feeds exactly one conv (a residual's 1x1 -> 3x3 -> 1x1
//      chain) writes its output already quantized with the consumer's
//      a_scale (REQ below): the epilogue rounds y to T and applies the
//      LeakyReLU in T as before, then quantizes that T value, so the
//      consumer sees the bytes it would have made itself, and the T tensor
//      between the two is never written.
//   2. An implicit GEMM on wgmma, fed by TMA (int8_conv_wgmma_kernel),
//      for stride 1, Cin % 16 == 0 (280 of the 296 launches: every 1x1
//      and 3x3 conv of the model at dilation 1, 3, 4 and 5). A block
//      computes 128 output pixels x BN output channels (pick_bn: 64 for
//      narrow outputs, 256 for long reductions on the large maps where
//      Cout allows it, else 128). The 128 pixels are a box of TB images x TH rows x TW columns,
//      TW = min(16, W), so an 8x8 map is 2 whole images and not a strip of
//      padding. For each tap (ky, kx) and each 64-channel slice, one
//      thread issues a 4-D TMA load of the int8 activations at (c0, ox0 +
//      kx*d - pad, oy0 + ky*d - pad, b0) and a 3-D TMA load of the weights
//      at (c0, tap, n0); TMA's out-of-bounds zero fill is the conv's zero
//      padding, and the ragged edges of H, W, N, Cin and Cout need no
//      masking on load. Both operands are K-major (NHWC and (Cout, K)
//      already are), land in shared memory with the 64-byte swizzle and
//      are read by wgmma.m64nBNk32.s32.s8.s8 through matching
//      descriptors. A ring of wg_stages() buffers with full/empty mbarriers
//      lets one producer warp keep the loads in flight while two consumer
//      warpgroups (64 pixel rows each) run the products; each releases a
//      stage once the next stage's products are issued. 288 threads and 4
//      stages let two blocks (BN = 128) or three (BN = 64) share an SM, so
//      one block's epilogue overlaps another's loads (a 1x1 conv on 64
//      channels is one stage). The
//      epilogue is the mma.sync kernel's arithmetic on wgmma's accumulator
//      layout; a 4 x 4
//      transpose by shuffles inside each quad of lanes hands each thread 8
//      adjacent outputs of one pixel, stored as one 16-byte (bf16), 32-byte
//      (fp32) or 8-byte (int8) write.
//   3. The other 16 launches keep the first design's mma.sync kernel
//      (int8_conv_kernel): the 7x7 stride-2 stem on 3 channels and the
//      1x1 merges on 50 channels, whose Cin is no multiple of 16 and so
//      cannot be a TMA tensor map's row (its strides must be multiples of
//      16 bytes). It quantizes on load, as before (see its note below).
// The route is chosen by shape alone, in ops/kernels.py.

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

namespace {

// ---------------------------------------------------------------------------
// 3. The first design's kernel, kept for the shapes no tensor map can take (Cin % 16 !=
// 0, or a stride): s8 x s8 -> s32 through mma.sync.m16n8k32. A 128 x BN
// output tile a block (BN = 64 or 128 output channels), 8 warps each owning
// 32 x BN/2, BK = 64 reduction steps staged through two shared-memory
// buffers, the next slice's global loads issued before the current slice's
// mma.sync so they overlap, the fragments read with ldmatrix. The
// activation slice is gathered per thread (im2col through L2) and quantized
// on its way into shared memory (a multiply by the reciprocal, with the
// IEEE division only where the product lies within a few ulp of a rounding
// tie). Rows of shared memory are padded to 80 bytes so that the fragment
// reads of a warp hit 32 distinct banks.
// ---------------------------------------------------------------------------

constexpr int BM = 128;       // output pixels a block
constexpr int BK = 64;        // reduction slice a stage
constexpr int LDS = BK + 16;  // shared row pitch in bytes
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round a float to T and back (identity for float)
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// clip(rint(v / a_scale), -127, 127) with the IEEE quotient, as a byte.
// t = v * (1 / a_scale) lies within ~2 ulp of the correctly rounded
// quotient q, so rint(t) == rint(q) unless a half-integer lies within a
// few ulp of t: only then is the division itself taken (the margin 2^-13
// is 8 ulp for |t| < 256). Clipping t before rounding gives the same
// integer (the bounds are integers) and keeps |t| <= 127, where adding
// 1.5 * 2^23 rounds to an integer, ties to even, and leaves it in the low
// bits of the sum: full-rate adds in place of the conversions (rint, float
// to int) that ran at a fraction of that rate in the epilogue.
__device__ __forceinline__ uint32_t quant(float v, float a_scale, float inv) {
  constexpr float kRound = 0x1.8p23f;
  const float t = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  float q = __fsub_rn(__fadd_rn(t, kRound), kRound);
  if (fabsf(fabsf(__fsub_rn(t, q)) - 0.5f) < 0x1p-13f)
    q = fminf(fmaxf(rintf(__fdiv_rn(v, a_scale)), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(q, kRound)) & 0xFFu;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory: r[k] gets, in lane L, the
// bytes 4 * (L & 3) .. + 3 of row L >> 2 of matrix k, which is the layout
// of an m16n8k32 s8 A fragment (four matrices) or of two B fragments
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint8_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

struct Shape {
  int n, h, w, cin, cout, kh, kw, stride, pad, dil, ho, wo, m, k;
};

// The activation operand of one thread: one output pixel (row of the
// tile) and 32 consecutive reduction indices of each BK slice. VEC (Cin a
// multiple of 8) loads 8 channels at a time; otherwise element by element.
template <typename T, bool VEC>
struct ALoad {
  static constexpr int RAW = VEC ? 4 * (8 * sizeof(T) / 16) : 1;
  uint4 raw[RAW];
  T sraw[VEC ? 1 : 32];
  const T* xb;
  int iy0, ix0;
  bool valid;

  __device__ void init(const T* x, const Shape& s, int m) {
    valid = m < s.m;
    const int mm = valid ? m : 0;
    const int b = mm / (s.ho * s.wo);
    const int rem = mm - b * s.ho * s.wo;
    const int oy = rem / s.wo, ox = rem - (rem / s.wo) * s.wo;
    iy0 = oy * s.stride - s.pad;
    ix0 = ox * s.stride - s.pad;
    xb = x + static_cast<size_t>(b) * s.h * s.w * s.cin;
  }

  __device__ void load(const Shape& s, int k) {
    const int tap = k / s.cin;
    int ci = k - tap * s.cin;
    int ky = tap / s.kw, kx = tap - (tap / s.kw) * s.kw;
    if (VEC) {
      constexpr int PER = 8 * sizeof(T) / 16;  // uint4 a group of 8
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int iy = iy0 + ky * s.dil, ix = ix0 + kx * s.dil;
        const bool in = valid && k + 8 * g < s.k && iy >= 0 && iy < s.h &&
                        ix >= 0 && ix < s.w;
        const uint4* p = reinterpret_cast<const uint4*>(
            xb + (static_cast<size_t>(in ? iy : 0) * s.w + (in ? ix : 0)) * s.cin + ci);
#pragma unroll
        for (int v = 0; v < PER; ++v)
          raw[g * PER + v] = in ? __ldg(p + v) : make_uint4(0, 0, 0, 0);
        ci += 8;
        if (ci >= s.cin) {
          ci -= s.cin;
          if (++kx == s.kw) { kx = 0; ++ky; }
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int iy = iy0 + ky * s.dil, ix = ix0 + kx * s.dil;
        const bool in = valid && k + e < s.k && iy >= 0 && iy < s.h &&
                        ix >= 0 && ix < s.w;
        sraw[e] = in ? xb[(static_cast<size_t>(iy) * s.w + ix) * s.cin + ci] : zero<T>();
        if (++ci == s.cin) {
          ci = 0;
          if (++kx == s.kw) { kx = 0; ++ky; }
        }
      }
    }
  }

  // quantize the 32 loaded values and write them (32 bytes) to `dst`
  __device__ void store(uint8_t* dst, float a, float inv) const {
    uint32_t words[8];
    const T* vals = VEC ? reinterpret_cast<const T*>(raw) : sraw;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      words[i] = quant(to_f32(vals[4 * i]), a, inv) |
                 quant(to_f32(vals[4 * i + 1]), a, inv) << 8 |
                 quant(to_f32(vals[4 * i + 2]), a, inv) << 16 |
                 quant(to_f32(vals[4 * i + 3]), a, inv) << 24;
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(words[0], words[1], words[2], words[3]);
    d[1] = make_uint4(words[4], words[5], words[6], words[7]);
  }
};

// The weight operand of one thread: BK / (THREADS / BN) consecutive bytes
// of one output channel's row of a BK slice.
template <int BN>
struct BLoad {
  static constexpr int TPR = THREADS / BN;   // threads a row
  static constexpr int BYTES = BK / TPR;     // 32 or 16
  static constexpr int VECS = BYTES / 16;
  uint4 raw[VECS];
  const int8_t* row;
  bool valid;
  int part;

  __device__ void init(const int8_t* w, const Shape& s, int o, int part_) {
    valid = o < s.cout;
    row = w + static_cast<size_t>(valid ? o : 0) * s.k;
    part = part_;
  }

  __device__ void load(const Shape& s, int k0) {
    const int k = k0 + part * BYTES;
    if ((s.k & 15) == 0) {
#pragma unroll
      for (int v = 0; v < VECS; ++v) {
        const bool in = valid && k + 16 * v < s.k;
        raw[v] = in ? __ldg(reinterpret_cast<const uint4*>(row + k) + v)
                    : make_uint4(0, 0, 0, 0);
      }
    } else {
      uint8_t* b = reinterpret_cast<uint8_t*>(raw);
#pragma unroll
      for (int e = 0; e < BYTES; ++e)
        b[e] = (valid && k + e < s.k) ? static_cast<uint8_t>(row[k + e]) : 0;
    }
  }

  __device__ void store(uint8_t* dst) const {
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int v = 0; v < VECS; ++v) d[v] = raw[v];
  }
};

template <typename T, bool VEC, int BN>
__global__ void __launch_bounds__(THREADS, 2)
int8_conv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ bias,
                 const float* __restrict__ w_scale,
                 const float* __restrict__ a_scale_p, T* __restrict__ out,
                 Shape s, int relu) {
  constexpr int NT = BN / 16;   // n8 tiles a warp (warp tile 32 x BN/2)
  __shared__ __align__(16) uint8_t As[2][BM * LDS];
  __shared__ __align__(16) uint8_t Bs[2][BN * LDS];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const float a_scale = *a_scale_p;
  const float inv = __frcp_rn(a_scale);

  ALoad<T, VEC> al;
  const int a_row = tid >> 1, a_half = tid & 1;
  al.init(x, s, m0 + a_row);
  BLoad<BN> bl;
  const int b_row = tid / BLoad<BN>::TPR, b_part = tid % BLoad<BN>::TPR;
  bl.init(w, s, n0 + b_row, b_part);

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, row8 = lane & 7;

  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  const int nk = (s.k + BK - 1) / BK;
  al.load(s, a_half * 32);
  bl.load(s, 0);
  al.store(&As[0][a_row * LDS + a_half * 32], a_scale, inv);
  bl.store(&Bs[0][b_row * LDS + b_part * BLoad<BN>::BYTES]);
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {                       // next slice's loads in flight
      al.load(s, (kt + 1) * BK + a_half * 32);
      bl.load(s, (kt + 1) * BK);
    }
    // fragments by ldmatrix.x4: lane L addresses row (L & 7) of 8x16-byte
    // matrix L >> 3; A's four are (rows 0-7 | 8-15) x (k 0-15 | 16-31),
    // B's four are k 0-15 | 16-31 of two n8 tiles
    const uint8_t* A = As[buf] + (wm * 32 + (mat & 1) * 8 + row8) * LDS + (mat >> 1) * 16;
    const uint8_t* B = Bs[buf] + (wn * (BN / 2) + (mat >> 1) * 8 + row8) * LDS +
                       (mat & 1) * 16;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], A + i * 16 * LDS + ks * 32);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, B + j * 8 * LDS + ks * 32);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_s8(acc[i][j], a[i], b[0], b[1]);
          mma_s8(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
    if (more) {
      al.store(&As[buf ^ 1][a_row * LDS + a_half * 32], a_scale, inv);
      bl.store(&Bs[buf ^ 1][b_row * LDS + b_part * BLoad<BN>::BYTES]);
    }
    __syncthreads();
  }

  // epilogue: dequantize, bias, cast, LeakyReLU; C fragment rows g and
  // g + 8, columns 2t and 2t + 1 of each m16n8 tile
  // (an even Cout stores the two columns of a thread as one pair)
  const bool pairs = (s.cout & 1) == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int o0 = n0 + wn * (BN / 2) + j * 8 + t * 2;
    if (o0 >= s.cout) continue;
    float scale[2], bo[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int o = o0 + c < s.cout ? o0 + c : o0;
      scale[c] = __fmul_rn(a_scale, w_scale[o]);
      bo[c] = bias[o];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + wm * 32 + i * 16 + g + hh * 8;
        if (m >= s.m) continue;
        float y[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          y[c] = round_to<T>(__fadd_rn(
              __fmul_rn(__int2float_rn(acc[i][j][hh * 2 + c]), scale[c]), bo[c]));
          if (relu && !(y[c] > 0.0f)) y[c] = round_to<T>(__fmul_rn(y[c], 0.01f));
        }
        T* dst = out + static_cast<size_t>(m) * s.cout + o0;
        if (pairs) {
          store_pair(dst, y[0], y[1]);
        } else {
          store_out(dst, y[0]);
          if (o0 + 1 < s.cout) store_out(dst + 1, y[1]);
        }
      }
    }
  }
}

template <typename T, bool VEC, int BN>
void launch(const void* x, const int8_t* w, const float* bias,
            const float* w_scale, const float* a_scale, void* out,
            const Shape& s, int relu, cudaStream_t stream) {
  const dim3 grid((s.m + BM - 1) / BM, (s.cout + BN - 1) / BN);
  int8_conv_kernel<T, VEC, BN><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), w, bias, w_scale, a_scale,
      static_cast<T*>(out), s, relu);
}

template <typename T>
void dispatch(const void* x, const int8_t* w, const float* bias,
              const float* w_scale, const float* a_scale, void* out,
              const Shape& s, int relu, cudaStream_t stream) {
  const bool vec = s.cin % 8 == 0;
  if (s.cout <= 64) {
    if (vec) launch<T, true, 64>(x, w, bias, w_scale, a_scale, out, s, relu, stream);
    else launch<T, false, 64>(x, w, bias, w_scale, a_scale, out, s, relu, stream);
  } else {
    if (vec) launch<T, true, 128>(x, w, bias, w_scale, a_scale, out, s, relu, stream);
    else launch<T, false, 128>(x, w, bias, w_scale, a_scale, out, s, relu, stream);
  }
}

}  // namespace

// x: (n, h, w, cin) NHWC, float32 (bf16 = 0) or bfloat16 (bf16 = 1); w:
// (cout, kh, kw, cin) int8; bias, w_scale: (cout,) float32; a_scale: one
// float32 on the device; out: (n, ho, wo, cout) of x's type. All
// contiguous, on the device. Launches on `stream`; returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int ibp_int8_conv(const void* x, const int8_t* w, const float* bias,
                             const float* w_scale, const float* a_scale,
                             void* out, int n, int h, int w_, int cin, int cout,
                             int kh, int kw, int stride, int pad, int dil,
                             int ho, int wo, int relu, int bf16, void* stream) {
  Shape s{n, h, w_, cin, cout, kh, kw, stride, pad, dil, ho, wo, n * ho * wo,
          kh * kw * cin};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    dispatch<__nv_bfloat16>(x, w, bias, w_scale, a_scale, out, s, relu, st);
  else
    dispatch<float>(x, w, bias, w_scale, a_scale, out, s, relu, st);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// ---------------------------------------------------------------------------
// 1. int8_quantize: bf16 or fp32 NHWC -> int8, 16 elements a thread
// ---------------------------------------------------------------------------

constexpr int Q_THREADS = 256;
constexpr int Q_PER = 16;

__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = __ldg(q + i);
    v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[16]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = __ldg(q + i);
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[8 * i + e] = __bfloat162float(b[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(Q_THREADS)
int8_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ out,
                     const float* __restrict__ a_scale_p, long long n) {
  const float a_scale = *a_scale_p;
  const float inv = __frcp_rn(a_scale);
  const long long i0 = (static_cast<long long>(blockIdx.x) * Q_THREADS + threadIdx.x) * Q_PER;
  if (i0 + Q_PER <= n) {
    float v[16];
    load16(x + i0, v);
    uint32_t words[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      words[i] = quant(v[4 * i], a_scale, inv) | quant(v[4 * i + 1], a_scale, inv) << 8 |
                 quant(v[4 * i + 2], a_scale, inv) << 16 |
                 quant(v[4 * i + 3], a_scale, inv) << 24;
    *reinterpret_cast<uint4*>(out + i0) = make_uint4(words[0], words[1], words[2], words[3]);
  } else {
    for (long long i = i0; i < n; ++i)
      out[i] = static_cast<int8_t>(quant(to_f32(x[i]), a_scale, inv));
  }
}

// ---------------------------------------------------------------------------
// 2. the implicit GEMM on wgmma, fed by TMA (stride 1, Cin % 16 == 0)
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128;       // output pixels a block (two m64 warpgroups)
constexpr int WG_BK = 64;        // channels a stage: one 64-byte swizzled row
// stages of the ring. Deeper rings where shared memory allows them (8 for
// BN = 256, 6 for BN = 128) measured no faster on an H100
// (tools/probe_int8_conv, variant deep_ring).
template <int BN>
__host__ __device__ constexpr int wg_stages() { return 4; }
constexpr int WG_CONSUMERS = 256;  // warpgroups 0-1: the products
constexpr int WG_THREADS = WG_CONSUMERS + 32;  // warp 8: the TMA producer

struct WShape {
  int n, h, w, cin, cout, k, pad, dil, ho, wo;
  int tw, th, tb;            // the pixel box: tb images x th rows x tw columns
  int tiles_x, tiles_y;      // boxes along wo and ho
  int nkc;                   // 64-channel slices of cin
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 64-byte rows with the
// 64-byte swizzle: 8-row groups 512 bytes apart (SBO); LBO is unused for a
// swizzled K-major operand; layout type 2 = 64-byte swizzle. The tile must
// start on a 512-byte boundary; a k32 step inside the row adds 32 bytes
// (2 in the address field).
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(512 >> 4) << 32 |
         static_cast<uint64_t>(2) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// D (64 x N, s32, in registers) += A (64 x 32 s8, shared) * B (N x 32 s8,
// shared)^T. Accumulator layout: thread (warp w, lane 4g + t) holds, for
// each n8 block j, rows 16w + g and 16w + g + 8 at columns 8j + 2t, +1 as
// d[4j], d[4j + 1] and d[4j + 2], d[4j + 3].
__device__ __forceinline__ void wgmma_mma(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_mma(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_mma(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// two output columns of one pixel: T values, or (REQ) the T values
// quantized with the consumer's scale
template <typename T, bool REQ>
__device__ __forceinline__ void emit(void* out, size_t idx, float y0, float y1,
                                     bool two, bool pair, float an, float inv_n) {
  if constexpr (REQ) {
    int8_t* p = static_cast<int8_t*>(out) + idx;
    const uint32_t q0 = quant(y0, an, inv_n), q1 = quant(y1, an, inv_n);
    if (pair) {
      *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(q0 | q1 << 8);
    } else {
      p[0] = static_cast<int8_t>(q0);
      if (two) p[1] = static_cast<int8_t>(q1);
    }
  } else {
    T* p = static_cast<T*>(out) + idx;
    if (pair) {
      store_pair(p, y0, y1);
    } else {
      store_out(p, y0);
      if (two) store_out(p + 1, y1);
    }
  }
}

// Two adjacent outputs of one pixel as the bytes they are stored as: two
// floats, two bf16 or (REQ) two int8 quantized with the consumer's scale.
template <typename T, bool REQ>
__device__ __forceinline__ uint2 pack2(float y0, float y1, float an, float inv_n) {
  if constexpr (REQ) {
    return make_uint2(quant(y0, an, inv_n) | quant(y1, an, inv_n) << 8, 0u);
  } else if constexpr (sizeof(T) == 4) {
    return make_uint2(__float_as_uint(y0), __float_as_uint(y1));
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(y0, y1);   // exact: y is bf16
    return make_uint2(*reinterpret_cast<const uint32_t*>(&h), 0u);
  }
}

__device__ __forceinline__ uint2 pick4(const uint2 (&p)[4], int i) {
  return i == 0 ? p[0] : i == 1 ? p[1] : i == 2 ? p[2] : p[3];
}

// 8 adjacent outputs of one pixel (the pieces of the 4 threads of a quad,
// in column order) as one 32-, 16- or 8-byte store
template <typename T, bool REQ>
__device__ __forceinline__ void store8(void* out, size_t idx, const uint2 (&o)[4]) {
  if constexpr (REQ) {
    *reinterpret_cast<uint2*>(static_cast<int8_t*>(out) + idx) =
        make_uint2(o[0].x | o[1].x << 16, o[2].x | o[3].x << 16);
  } else if constexpr (sizeof(T) == 4) {
    uint4* p = reinterpret_cast<uint4*>(static_cast<T*>(out) + idx);
    p[0] = make_uint4(o[0].x, o[0].y, o[1].x, o[1].y);
    p[1] = make_uint4(o[2].x, o[2].y, o[3].x, o[3].y);
  } else {
    *reinterpret_cast<uint4*>(static_cast<T*>(out) + idx) =
        make_uint4(o[0].x, o[1].x, o[2].x, o[3].x);
  }
}

template <typename T, bool REQ, int BN>
__global__ void __launch_bounds__(WG_THREADS, BN == 256 ? 1 : BN == 128 ? 2 : 3)
int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w,
                       const float* __restrict__ bias,
                       const float* __restrict__ w_scale,
                       const float* __restrict__ a_scale_p,
                       const float* __restrict__ a_next_p,
                       void* __restrict__ out, WShape s, int relu) {
  constexpr int A_BYTES = WG_BM * WG_BK;   // 8 KB
  constexpr int B_BYTES = BN * WG_BK;      // 4, 8 or 16 KB
  constexpr int NACC = BN / 2;
  constexpr int WG_STAGES = wg_stages<BN>();
  extern __shared__ uint8_t smem_raw[];
  // stage buffers on 1024-byte boundaries (the swizzle pattern's period)
  uint8_t* As = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Bs = As + WG_STAGES * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + WG_STAGES * B_BYTES);
  uint64_t* empty = full + WG_STAGES;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < WG_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);     // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int tile = blockIdx.x;
  const int tx = tile % s.tiles_x;
  tile /= s.tiles_x;
  const int ty = tile % s.tiles_y;
  const int ox0 = tx * s.tw, oy0 = ty * s.th, b0 = (tile / s.tiles_y) * s.tb;
  const int n0 = blockIdx.y * BN;
  const int nk = s.k * s.k * s.nkc;

  if (tid >= WG_CONSUMERS) {
    // producer: one thread keeps the ring's loads in flight
    if (tid == WG_CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < nk; ++it) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], A_BYTES + B_BYTES);
        const int tap = it / s.nkc, c0 = (it - tap * s.nkc) * WG_BK;
        const int ky = tap / s.k, kx = tap - ky * s.k;
        tma_load_4d(As + stage * A_BYTES, &tm_x, &full[stage], c0,
                    ox0 + kx * s.dil - s.pad, oy0 + ky * s.dil - s.pad, b0);
        tma_load_3d(Bs + stage * B_BYTES, &tm_w, &full[stage], c0, tap, n0);
        if (++stage == WG_STAGES) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns pixel rows 64 cw .. 64 cw + 63 of the box
  const int cw = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  int acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;
  {
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int it = 0; it < nk; ++it) {
      mbar_wait(&full[stage], phase);
      const uint64_t da = desc_sw64(As + stage * A_BYTES + cw * 64 * WG_BK);
      const uint64_t db = desc_sw64(Bs + stage * B_BYTES);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < WG_BK / 32; ++ks)
        wgmma_mma(acc, da + 2 * ks, db + 2 * ks);
      wgmma_commit();
      wgmma_wait<1>();             // the previous stage's products are done
      fence_acc(acc);
      if (it > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == WG_STAGES) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_acc(acc);
  }

  // epilogue: dequantize, bias, cast, LeakyReLU [, requantize]
  const float a_scale = *a_scale_p;
  float a_next = 0.0f, inv_next = 0.0f;
  if (REQ) {
    a_next = *a_next_p;
    inv_next = __frcp_rn(a_next);
  }
  const int g = lane >> 2, t = lane & 3;
  size_t m[2];
  bool mval[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = cw * 64 + warp * 16 + g + hh * 8;
    const int xx = r % s.tw, q = r / s.tw;
    const int x = ox0 + xx, y = oy0 + q % s.th, b = b0 + q / s.th;
    mval[hh] = x < s.wo && y < s.ho && b < s.n;
    m[hh] = (static_cast<size_t>(b) * s.ho + y) * s.wo + x;
  }
  if ((s.cout & 7) == 0) {
    // groups of 4 n8 blocks: a 4 x 4 transpose inside each quad (shuffles)
    // hands thread t all 8 columns of block 4 jg + t of its row, so each
    // store writes 8 adjacent outputs
    const int quad = lane & ~3;
#pragma unroll
    for (int jg = 0; jg < BN / 32; ++jg) {
      const int col = n0 + (jg * 4 + t) * 8;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint2 piece[4], mine[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float y[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int o = min(n0 + (jg * 4 + jj) * 8 + t * 2 + c, s.cout - 1);
            y[c] = round_to<T>(__fadd_rn(
                __fmul_rn(__int2float_rn(acc[4 * (jg * 4 + jj) + 2 * hh + c]),
                          __fmul_rn(a_scale, __ldg(w_scale + o))), __ldg(bias + o)));
            if (relu && !(y[c] > 0.0f)) y[c] = round_to<T>(__fmul_rn(y[c], 0.01f));
          }
          piece[jj] = pack2<T, REQ>(y[0], y[1], a_next, inv_next);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // round r: send block (t - r) to lane t - r, take block t from t + r
          const uint2 v = pick4(piece, (t - r) & 3);
          const int src = (t + r) & 3;
          uint2 got;
          got.x = __shfl_sync(0xffffffffu, v.x, quad | src);
          got.y = (!REQ && sizeof(T) == 4) ? __shfl_sync(0xffffffffu, v.y, quad | src) : 0u;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k == src) mine[k] = got;
        }
        if (mval[hh] && col < s.cout) store8<T, REQ>(out, m[hh] * s.cout + col, mine);
      }
    }
    return;
  }
  // Cout not a multiple of 8: two columns a store
  const bool pairs = (s.cout & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int o0 = n0 + j * 8 + t * 2;
    if (o0 >= s.cout) continue;
    const bool two = o0 + 1 < s.cout;
    float scale[2], bo[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int o = (c == 0 || two) ? o0 + c : o0;
      scale[c] = __fmul_rn(a_scale, __ldg(w_scale + o));
      bo[c] = __ldg(bias + o);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!mval[hh]) continue;
      float y[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        y[c] = round_to<T>(__fadd_rn(
            __fmul_rn(__int2float_rn(acc[4 * j + 2 * hh + c]), scale[c]), bo[c]));
        if (relu && !(y[c] > 0.0f)) y[c] = round_to<T>(__fmul_rn(y[c], 0.01f));
      }
      emit<T, REQ>(out, m[hh] * s.cout + o0, y[0], y[1], two, pairs, a_next,
                   inv_next);
    }
  }
}

// ---- host side: tensor maps and the launch ---------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// loaded (looked up once; null where it is missing)
EncodeTiledFn encoder() {
  static const EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return h ? reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// An int8 tensor map with the 64-byte swizzle and zero fill out of bounds;
// dims[0] is contiguous, strides[i] is the byte stride of dims[i + 1].
int encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return -1;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
                        const_cast<void*>(ptr), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
}

// A weight's map depends on its pointer and shape only, and a QConv2d's
// weight never moves: encode it once. The key holds everything the map is
// made of, so a reused address with the same shape gets the same map.
int weight_map(CUtensorMap* map, const int8_t* w, int cin, int taps, int cout,
               int bn) {
  static std::mutex mu;
  static std::map<std::array<uint64_t, 5>, CUtensorMap> cache;
  const std::array<uint64_t, 5> key = {reinterpret_cast<uint64_t>(w),
                                       static_cast<uint64_t>(cin),
                                       static_cast<uint64_t>(taps),
                                       static_cast<uint64_t>(cout),
                                       static_cast<uint64_t>(bn)};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return 0;
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(taps),
                              static_cast<cuuint64_t>(cout)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cin),
                                 static_cast<cuuint64_t>(cin) * taps};
  const cuuint32_t box[3] = {WG_BK, 1, static_cast<cuuint32_t>(bn)};
  const int err = encode(map, w, 3, dims, strides, box);
  if (err == 0) cache.emplace(key, *map);
  return err;
}

int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

template <typename T, bool REQ, int BN>
int launch_wgmma(const int8_t* xq, const int8_t* w, const float* bias,
                 const float* w_scale, const float* a_scale,
                 const float* a_next, void* out, WShape s, int relu,
                 cudaStream_t stream) {
  constexpr int SMEM = wg_stages<BN>() * ((WG_BM + BN) * WG_BK + 16) + 1024;
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  static uint64_t attr_set = 0;        // devices whose limit is raised
  static std::mutex mu;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (dev < 64 && !(attr_set >> dev & 1)) {
      ce = cudaFuncSetAttribute(int8_conv_wgmma_kernel<T, REQ, BN>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
      if (ce != cudaSuccess) return static_cast<int>(ce);
      attr_set |= uint64_t{1} << dev;
    }
  }
  s.tw = pow2_ceil(s.wo) < 16 ? pow2_ceil(s.wo) : 16;
  s.th = pow2_ceil(s.ho) < WG_BM / s.tw ? pow2_ceil(s.ho) : WG_BM / s.tw;
  s.tb = WG_BM / (s.tw * s.th);
  s.tiles_x = (s.wo + s.tw - 1) / s.tw;
  s.tiles_y = (s.ho + s.th - 1) / s.th;
  s.nkc = (s.cin + WG_BK - 1) / WG_BK;
  const long long tiles =
      static_cast<long long>(s.tiles_x) * s.tiles_y * ((s.n + s.tb - 1) / s.tb);
  if (tiles >= (1LL << 31)) return -2;

  CUtensorMap tm_x, tm_w;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(s.cin), static_cast<cuuint64_t>(s.w),
                              static_cast<cuuint64_t>(s.h), static_cast<cuuint64_t>(s.n)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.cin),
                                 static_cast<cuuint64_t>(s.cin) * s.w,
                                 static_cast<cuuint64_t>(s.cin) * s.w * s.h};
  const cuuint32_t box[4] = {WG_BK, static_cast<cuuint32_t>(s.tw),
                             static_cast<cuuint32_t>(s.th), static_cast<cuuint32_t>(s.tb)};
  int err = encode(&tm_x, xq, 4, dims, strides, box);
  if (err) return err;
  err = weight_map(&tm_w, w, s.cin, s.k * s.k, s.cout, BN);
  if (err) return err;
  const dim3 grid(static_cast<unsigned>(tiles), (s.cout + BN - 1) / BN);
  int8_conv_wgmma_kernel<T, REQ, BN><<<grid, WG_THREADS, SMEM, stream>>>(
      tm_x, tm_w, bias, w_scale, a_scale, a_next, out, s, relu);
  return static_cast<int>(cudaGetLastError());
}

// The output-channel tile, by shape: 64 for narrow outputs (three blocks
// an SM); 256 where Cout is a multiple of it, the reduction is long (K >=
// 1,024: each activation tile is then read once for every 256 outputs,
// not every 128) and the map large enough that the wider tiles still fill
// the card twice over; else 128 (two blocks an SM, which a short
// reduction needs more than wide tiles).
int pick_bn(const WShape& s) {
  const long long pixel_tiles = (static_cast<long long>(s.n) * s.ho * s.wo + WG_BM - 1) / WG_BM;
  if (s.cout <= 64) return 64;
  if (s.cout % 256 == 0 && s.k * s.k * s.cin >= 1024 &&
      pixel_tiles * (s.cout / 256) >= 264) return 256;
  return 128;
}

template <typename T>
int dispatch_wgmma(const int8_t* xq, const int8_t* w, const float* bias,
                   const float* w_scale, const float* a_scale,
                   const float* a_next, void* out, const WShape& s, int relu,
                   cudaStream_t st) {
  const int bn = pick_bn(s);
  if (bn == 256)
    return a_next ? launch_wgmma<T, true, 256>(xq, w, bias, w_scale, a_scale, a_next, out, s, relu, st)
                  : launch_wgmma<T, false, 256>(xq, w, bias, w_scale, a_scale, a_next, out, s, relu, st);
  if (bn == 64)
    return a_next ? launch_wgmma<T, true, 64>(xq, w, bias, w_scale, a_scale, a_next, out, s, relu, st)
                  : launch_wgmma<T, false, 64>(xq, w, bias, w_scale, a_scale, a_next, out, s, relu, st);
  return a_next ? launch_wgmma<T, true, 128>(xq, w, bias, w_scale, a_scale, a_next, out, s, relu, st)
                : launch_wgmma<T, false, 128>(xq, w, bias, w_scale, a_scale, a_next, out, s, relu, st);
}

}  // namespace

// x: a contiguous bf16 (bf16 = 1) or float32 tensor of n elements on the
// device, 16-byte aligned; out: n int8; a_scale: one float32 on the device.
// Launches on `stream`; returns cudaGetLastError() as an int.
extern "C" int ibp_int8_quantize(const void* x, int8_t* out, const float* a_scale,
                                 long long n, int bf16, void* stream) {
  const long long threads = (n + Q_PER - 1) / Q_PER;
  const unsigned blocks = static_cast<unsigned>((threads + Q_THREADS - 1) / Q_THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks == 0) return 0;
  if (bf16)
    int8_quantize_kernel<__nv_bfloat16><<<blocks, Q_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), out, a_scale, n);
  else
    int8_quantize_kernel<float><<<blocks, Q_THREADS, 0, st>>>(
        static_cast<const float*>(x), out, a_scale, n);
  return static_cast<int>(cudaGetLastError());
}

// x: null, or the (n, h, w, cin) bf16 (x_bf16 = 1) or float32 NHWC input,
// 16-byte aligned, quantized here into xq with a_scale (one int8_quantize
// launch before the GEMM); xq: (n, h, w, cin) int8 NHWC, cin % 16 == 0,
// 16-byte aligned; w: (cout, k, k, cin) int8, 16-byte aligned; bias,
// w_scale: (cout,) float32; a_scale: xq's scale, one float32 on the device;
// a_next: null, or the consumer's scale (one float32 on the device) to
// write out as int8; out: (n, ho, wo, cout) of the compute type (bf16 = 1:
// bfloat16, else float32) or int8. Stride 1. Launches on `stream`; returns
// 0, a CUDA error, -1 (no cuTensorMapEncodeTiled), -2 (too many tiles) or
// 10000 + a CUresult.
extern "C" int ibp_int8_conv_wgmma(const void* x, int x_bf16, int8_t* xq,
                                   const int8_t* w, const float* bias,
                                   const float* w_scale, const float* a_scale,
                                   const float* a_next, void* out, int n, int h,
                                   int w_, int cin, int cout, int k, int pad,
                                   int dil, int ho, int wo, int relu, int bf16,
                                   void* stream) {
  if (x != nullptr) {
    const int err = ibp_int8_quantize(x, xq, a_scale,
                                      static_cast<long long>(n) * h * w_ * cin,
                                      x_bf16, stream);
    if (err) return err;
  }
  WShape s{n, h, w_, cin, cout, k, pad, dil, ho, wo, 0, 0, 0, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_wgmma<__nv_bfloat16>(xq, w, bias, w_scale, a_scale, a_next, out, s, relu, st);
  return dispatch_wgmma<float>(xq, w, bias, w_scale, a_scale, a_next, out, s, relu, st);
}
