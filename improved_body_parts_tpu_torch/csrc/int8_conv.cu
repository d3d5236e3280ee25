// int8 convolution for Hopper (sm_90a): an implicit GEMM on the tensor
// cores, s8 x s8 -> s32 through mma.sync.m16n8k32.
//
// Replaces XLA's int8 convolution of the JAX package's int8 forward,
// improved_body_parts_tpu/models/imhn.py ConvBlock(quant="int8") (:78-99:
// lax.conv_general_dilated(..., preferred_element_type=int32)). It computes
// exactly what that block computes, in its operation order:
//   xq  = clip(rint(x_f32 / a_scale), -127, 127)     (IEEE division, ties
//                                                      to even, as each
//                                                      operand is loaded)
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
// Bound: at the model's shapes the tensor-core work (2 * M * Cout * K
// operations at 1,979 int8 TOPS) is the larger part of the bound for the
// wide layers and the activation bytes for the narrow ones. This first
// design is simple and exact rather than fast: a 128 x BN output tile a
// block (BN = 64 or 128 output channels), 8 warps each owning 32 x BN/2,
// BK = 64 reduction steps staged through two shared-memory buffers, the
// next slice's global loads issued before the current slice's mma.sync so
// they overlap, the mma fragments read with ldmatrix. The activation slice is quantized on its way into shared
// memory (a multiply by the reciprocal, with the IEEE division only where
// the product lies within a few ulp of a rounding tie); it is re-quantized
// for every tap and for every BN-wide column of blocks, which a later
// design (wgmma with TMA, the quantized operand written once by the
// producing layer's epilogue) removes. Rows of shared memory are padded to 80 bytes so that
// the fragment reads of a warp hit 32 distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// is 8 ulp for |t| < 256; beyond, both clip to +-127).
__device__ __forceinline__ uint32_t quant(float v, float a_scale, float inv) {
  const float t = v * inv;
  float q = rintf(t);
  if (fabsf(fabsf(t - q) - 0.5f) < 0x1p-13f) q = rintf(__fdiv_rn(v, a_scale));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)));
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
