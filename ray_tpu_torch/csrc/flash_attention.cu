// Flash attention for Hopper (sm_90a): the forward kernel and the two
// backward kernels (dq; dk and dv), with a plain C interface for ctypes.
//
// Replaces the three Pallas kernels of ray_tpu/ops/attention.py:
//   fa_fwd_kernel     <- _fa_kernel      (online-softmax forward, emits lse)
//   fa_bwd_dq_kernel  <- _bwd_dq_kernel  (dq accumulated over kv tiles)
//   fa_bwd_dkv_kernel <- _bwd_dkv_kernel (dk, dv accumulated over q tiles)
//
// Layout. q, k, v, o, do and the gradients are contiguous (B, T, H, D)
// tensors, read in place through their strides (no folded copy); lse and
// delta are plain (B*H, T) fp32 arrays. Rows past T are zero-filled on load
// and masked out of every score, so any T >= 1 runs in the kernel.
//
// Design. On the TPU the innermost grid dimension runs in order and carries
// the running statistics in VMEM scratch. Here that sequential dimension is
// a loop inside one thread block, so blocks share nothing and no atomics
// are needed. A block of 4 warps owns a 64-row tile; each warp owns 16 of
// those rows and keeps its accumulators in registers, laid out as the
// fragments of mma.sync.m16n8k16 (bf16 in, fp32 accumulate). Operands come
// from shared memory; the probabilities (or dS) take a round trip through
// a per-warp shared buffer before their second product. fp32 inputs take
// the same path with the products done as scalar fp32 FMAs into the same
// fragment layout.
//
// Precision of P. `_fa_kernel` upcasts v to fp32, so its P.V product takes
// P in fp32; the backward kernels cast P and dS to the input dtype before
// their products. The forward kernel keeps P's precision with bf16 inputs
// by splitting it into hi = bf16(p) and lo = bf16(p - hi) and running two
// MMAs that share V's fragments: hi + lo carries 16 of p's 24 mantissa
// bits, and what is dropped is below 2^-17 |p|. The backward kernels round
// P and dS to bf16, as their Pallas counterparts do.
//
// Bound. At the bench-350m shape (B 8, T 2048, H 16, D 64, causal) each
// kernel does ~130-270 FLOP per byte it must move, below the H100's ~295
// FLOP/byte ridge, so an ideal kernel sits near both roofs; this first
// version is bound by its shared-memory operand loads and the scalar
// 16-bit loads of the k-major operand, not by HBM. The causal skip (tiles
// above the diagonal are never loaded) halves the work, as in the TPU
// kernels. wgmma, TMA and warp specialisation are the later steps.
//
// Arithmetic follows the Pallas kernels: scores in fp32, the scale applied
// before masking, masked scores set to -1e30 (not -inf, so a fully masked
// row never forms exp(-inf - -inf)), fp32 accumulation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockM = 64;  // rows of the tile a block owns
constexpr int kBlockN = 64;  // rows of each tile the block loops over
constexpr int kWarps = 4;    // each warp owns 16 of the kBlockM rows
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  static constexpr int kPad = 4;  // row pad (elements) against bank conflicts
  static constexpr int kVec = 4;  // elements per 16-byte load
};
template <>
struct Traits<bf16> {
  static constexpr int kPad = 8;
  static constexpr int kVec = 8;
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// Copies rows [row0, row0 + kRows) of one (b, h) slice into shared memory
// with row stride D + pad; rows at or past `rows` are zero-filled.
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int rows) {
  constexpr int kLd = D + Traits<T>::kPad;
  constexpr int kVec = Traits<T>::kVec;
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const int4*>(src + (row0 + r) * row_stride + c);
    }
    *reinterpret_cast<int4*>(dst + r * kLd + c) = val;
  }
}

// Fills a shared fp32 vector with v[row0 + i] (0 past `rows`).
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows) {
  for (int i = threadIdx.x; i < kBlockN; i += kThreads) {
    dst[i] = row0 + i < rows ? src[row0 + i] : 0.f;
  }
}

__device__ __forceinline__ uint32_t pack2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of one m16n8k16 step: rows g, g + 8, columns k0 + 2t + {0,
// 1, 8, 9} of a row-major 16-row tile.
__device__ __forceinline__ void load_a(uint32_t* af, const bf16* a, int lda,
                                       int k0, int g, int t) {
  af[0] = pack2(a + g * lda + k0 + 2 * t);
  af[1] = pack2(a + (g + 8) * lda + k0 + 2 * t);
  af[2] = pack2(a + g * lda + k0 + 8 + 2 * t);
  af[3] = pack2(a + (g + 8) * lda + k0 + 8 + 2 * t);
}

// One warp: acc (16 x 8*NT, fragment layout) += A (16 x K) . B (K x 8*NT).
// A is row-major at `a` (row stride lda). B is read as b[n*ldb + k] when
// kNK (the n-major tile, e.g. K for Q.K^T) and as b[k*ldb + n] otherwise.
// With kHiLo (bf16 only) it also adds A_lo . B, A_lo laid out as A at
// `a_lo`, reusing each B fragment for both products.
// Fragment entry acc[j][e] is row g + 8*(e/2), column 8*j + 2*t + e%2, where
// g = lane/4 and t = lane%4.
template <typename T, int NT, int K, bool kNK, bool kHiLo = false>
__device__ __forceinline__ void warp_gemm(float (*acc)[4], const T* a,
                                          int lda, const T* b, int ldb,
                                          const T* a_lo = nullptr) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t af[4];
      uint32_t af_lo[4];
      load_a(af, a, lda, k0, g, t);
      if constexpr (kHiLo) load_a(af_lo, a_lo, lda, k0, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = j * 8 + g;
        uint32_t bfr[2];
        if constexpr (kNK) {
          bfr[0] = pack2(b + n * ldb + k0 + 2 * t);
          bfr[1] = pack2(b + n * ldb + k0 + 8 + 2 * t);
        } else {
          bfr[0] = pack2(b[(k0 + 2 * t) * ldb + n], b[(k0 + 2 * t + 1) * ldb + n]);
          bfr[1] = pack2(b[(k0 + 2 * t + 8) * ldb + n],
                         b[(k0 + 2 * t + 9) * ldb + n]);
        }
        mma_bf16(acc[j], af, bfr);
        if constexpr (kHiLo) mma_bf16(acc[j], af_lo, bfr);
      }
    }
  } else {
    static_assert(!kHiLo, "the hi/lo split is for bf16 operands");
    for (int k = 0; k < K; ++k) {
      const float a0 = a[g * lda + k];
      const float a1 = a[(g + 8) * lda + k];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c0 = j * 8 + 2 * t;
        const float b0 = kNK ? b[c0 * ldb + k] : b[k * ldb + c0];
        const float b1 = kNK ? b[(c0 + 1) * ldb + k] : b[k * ldb + c0 + 1];
        acc[j][0] = fmaf(a0, b0, acc[j][0]);
        acc[j][1] = fmaf(a0, b1, acc[j][1]);
        acc[j][2] = fmaf(a1, b0, acc[j][2]);
        acc[j][3] = fmaf(a1, b1, acc[j][3]);
      }
    }
  }
}

// Stores a probability for the P.V product: bf16 as hi + lo parts (see the
// note at the top), fp32 as it is (lo unused).
__device__ __forceinline__ void store_p(float* hi, float*, float p) {
  *hi = p;
}
__device__ __forceinline__ void store_p(bf16* hi, bf16* lo, float p) {
  const bf16 h = __float2bfloat16(p);
  *hi = h;
  *lo = __float2bfloat16(p - __bfloat162float(h));
}

template <int NT>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
}

// Reduces across the 4 lanes that share a fragment row.
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Writes a warp's 16 x 8*NT fragment, times `scale`, to rows row0.. of a
// (T, H, D)-strided slice, skipping rows at or past `rows`.
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* dst, int64_t row_stride,
                                           float (*acc)[4], float scale,
                                           int row0, int rows) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1);
      if (row < rows) {
        dst[row * row_stride + j * 8 + 2 * t + (e & 1)] =
            from_float<T>(acc[j][e] * scale);
      }
    }
  }
}

template <typename T, int D>
__host__ __device__ constexpr int tile_elems() {
  return kBlockM * (D + Traits<T>::kPad);
}
template <typename T>
__host__ __device__ constexpr int warp_buf_elems() {
  return kWarps * 16 * (kBlockN + Traits<T>::kPad);
}

// ---------------------------------------------------------------------------
// Forward. Grid (ceil(Tq/64), B*H). Replaces _fa_kernel
// (ray_tpu/ops/attention.py): the kv sweep that the TPU runs as its
// sequential grid axis is the loop over n0, with the running max m,
// denominator l and accumulator in registers.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, int H, int Tq, int Tkv,
                  float scale, int causal) {
  constexpr int kLd = D + Traits<T>::kPad;
  constexpr int kLdp = kBlockN + Traits<T>::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + tile_elems<T, D>();
  T* vs = ks + tile_elems<T, D>();
  T* ps = vs + tile_elems<T, D>();
  T* ps_lo = ps + warp_buf_elems<T>();  // bf16 only
  constexpr bool kHiLo = std::is_same<T, bf16>::value;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t row_stride = static_cast<int64_t>(H) * D;
  const int64_t q_off = (static_cast<int64_t>(b) * Tq * H + h) * D;
  const int64_t kv_off = (static_cast<int64_t>(b) * Tkv * H + h) * D;

  load_tile<T, D, kBlockM>(qs, q + q_off, row_stride, q0, Tq);
  const T* qw = qs + warp * 16 * kLd;
  T* pw = ps + warp * 16 * kLdp;
  T* pw_lo = ps_lo + warp * 16 * kLdp;
  const int wrow = q0 + warp * 16 + g;  // this lane's rows: wrow, wrow + 8

  float acc[D / 8][4];
  zero<D / 8>(acc);
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  // Causal: a kv tile is live iff its first row <= the q tile's last row.
  const int kv_end = causal ? min(Tkv, q0 + kBlockM) : Tkv;
  for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous k, v tiles
    load_tile<T, D, kBlockN>(ks, k + kv_off, row_stride, n0, Tkv);
    load_tile<T, D, kBlockN>(vs, v + kv_off, row_stride, n0, Tkv);
    __syncthreads();

    float s[kBlockN / 8][4];
    zero<kBlockN / 8>(s);
    warp_gemm<T, kBlockN / 8, D, true>(s, qw, kLd, ks, kLd);

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wrow + 8 * (e >> 1);
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (row >= Tq || col >= Tkv || (causal && col > row)) x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], row_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += p;
        const int idx = (g + 8 * (e >> 1)) * kLdp + j * 8 + 2 * t + (e & 1);
        store_p(pw + idx, pw_lo + idx, p);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + row_sum(sum[r]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    }
    __syncwarp();
    warp_gemm<T, D / 8, kBlockN, false, kHiLo>(acc, pw, kLdp, vs, kLd, pw_lo);
    __syncwarp();  // the next tile's P overwrites pw
  }

  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= inv_l[e >> 1];
  }
  store_rows<T, D / 8>(o + q_off, row_stride, acc, 1.f, q0 + warp * 16, Tq);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + 8 * r;
      if (row < Tq) lse[static_cast<int64_t>(bh) * Tq + row] = m[r] + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// dq. Grid (ceil(Tq/64), B*H). Replaces _bwd_dq_kernel: the block owns a q
// tile and loops over the live kv tiles, dq in registers.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int H, int Tq, int Tkv, float scale, int causal) {
  constexpr int kLd = D + Traits<T>::kPad;
  constexpr int kLdp = kBlockN + Traits<T>::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + tile_elems<T, D>();
  T* ks = dos + tile_elems<T, D>();
  T* vs = ks + tile_elems<T, D>();
  T* dss = vs + tile_elems<T, D>();

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t row_stride = static_cast<int64_t>(H) * D;
  const int64_t q_off = (static_cast<int64_t>(b) * Tq * H + h) * D;
  const int64_t kv_off = (static_cast<int64_t>(b) * Tkv * H + h) * D;

  load_tile<T, D, kBlockM>(qs, q + q_off, row_stride, q0, Tq);
  load_tile<T, D, kBlockM>(dos, dout + q_off, row_stride, q0, Tq);
  const T* qw = qs + warp * 16 * kLd;
  const T* dow = dos + warp * 16 * kLd;
  T* dsw = dss + warp * 16 * kLdp;
  const int wrow = q0 + warp * 16 + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + 8 * r;
    const int64_t i = static_cast<int64_t>(bh) * Tq + row;
    lse_r[r] = row < Tq ? lse[i] : 0.f;
    delta_r[r] = row < Tq ? delta[i] : 0.f;
  }

  float acc[D / 8][4];
  zero<D / 8>(acc);
  const int kv_end = causal ? min(Tkv, q0 + kBlockM) : Tkv;
  for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {
    __syncthreads();
    load_tile<T, D, kBlockN>(ks, k + kv_off, row_stride, n0, Tkv);
    load_tile<T, D, kBlockN>(vs, v + kv_off, row_stride, n0, Tkv);
    __syncthreads();

    float s[kBlockN / 8][4];
    float dp[kBlockN / 8][4];
    zero<kBlockN / 8>(s);
    zero<kBlockN / 8>(dp);
    warp_gemm<T, kBlockN / 8, D, true>(s, qw, kLd, ks, kLd);
    warp_gemm<T, kBlockN / 8, D, true>(dp, dow, kLd, vs, kLd);
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int row = wrow + 8 * r;
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (row >= Tq || col >= Tkv || (causal && col > row)) x = kNegInf;
        const float p = expf(x - lse_r[r]);
        dsw[(g + 8 * r) * kLdp + j * 8 + 2 * t + (e & 1)] =
            from_float<T>(p * (dp[j][e] - delta_r[r]));
      }
    }
    __syncwarp();
    warp_gemm<T, D / 8, kBlockN, false>(acc, dsw, kLdp, ks, kLd);
    __syncwarp();
  }
  store_rows<T, D / 8>(dq + q_off, row_stride, acc, scale, q0 + warp * 16, Tq);
}

// ---------------------------------------------------------------------------
// dk, dv. Grid (ceil(Tkv/64), B*H). Replaces _bwd_dkv_kernel: the block owns
// a kv tile and loops over the live q tiles, dk and dv in registers. Each
// warp computes the transposed scores S^T = K.Q^T for its 16 kv rows, so
// P^T and dS^T come out in the layout the dv and dk products need.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Tq, int Tkv, float scale,
                      int causal) {
  constexpr int kLd = D + Traits<T>::kPad;
  constexpr int kLdp = kBlockN + Traits<T>::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + tile_elems<T, D>();
  T* qs = vs + tile_elems<T, D>();
  T* dos = qs + tile_elems<T, D>();
  T* ps = dos + tile_elems<T, D>();
  float* lse_s = reinterpret_cast<float*>(ps + warp_buf_elems<T>());
  float* delta_s = lse_s + kBlockN;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kv0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t row_stride = static_cast<int64_t>(H) * D;
  const int64_t q_off = (static_cast<int64_t>(b) * Tq * H + h) * D;
  const int64_t kv_off = (static_cast<int64_t>(b) * Tkv * H + h) * D;
  const float* lse_bh = lse + static_cast<int64_t>(bh) * Tq;
  const float* delta_bh = delta + static_cast<int64_t>(bh) * Tq;

  load_tile<T, D, kBlockM>(ks, k + kv_off, row_stride, kv0, Tkv);
  load_tile<T, D, kBlockM>(vs, v + kv_off, row_stride, kv0, Tkv);
  const T* kw = ks + warp * 16 * kLd;
  const T* vw = vs + warp * 16 * kLd;
  T* pw = ps + warp * 16 * kLdp;
  const int wrow = kv0 + warp * 16 + g;  // this lane's kv rows

  float dk_acc[D / 8][4];
  float dv_acc[D / 8][4];
  zero<D / 8>(dk_acc);
  zero<D / 8>(dv_acc);
  // Causal: a q tile is live iff its last row >= the kv tile's first row.
  const int q_begin = causal ? (kv0 / kBlockN) * kBlockN : 0;
  for (int q0 = q_begin; q0 < Tq; q0 += kBlockN) {
    __syncthreads();
    load_tile<T, D, kBlockN>(qs, q + q_off, row_stride, q0, Tq);
    load_tile<T, D, kBlockN>(dos, dout + q_off, row_stride, q0, Tq);
    load_rows(lse_s, lse_bh, q0, Tq);
    load_rows(delta_s, delta_bh, q0, Tq);
    __syncthreads();

    float p[kBlockN / 8][4];
    zero<kBlockN / 8>(p);
    warp_gemm<T, kBlockN / 8, D, true>(p, kw, kLd, qs, kLd);
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wrow + 8 * (e >> 1);  // kv position
        const int qi = j * 8 + 2 * t + (e & 1);
        const int col = q0 + qi;              // q position
        float x = p[j][e] * scale;
        if (col >= Tq || row >= Tkv || (causal && row > col)) x = kNegInf;
        p[j][e] = expf(x - lse_s[qi]);
        pw[(g + 8 * (e >> 1)) * kLdp + qi] = from_float<T>(p[j][e]);
      }
    }
    __syncwarp();
    warp_gemm<T, D / 8, kBlockN, false>(dv_acc, pw, kLdp, dos, kLd);

    float dp[kBlockN / 8][4];
    zero<kBlockN / 8>(dp);
    warp_gemm<T, kBlockN / 8, D, true>(dp, vw, kLd, dos, kLd);
    __syncwarp();  // every lane is done reading P^T before dS^T replaces it
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1);
        pw[(g + 8 * (e >> 1)) * kLdp + qi] =
            from_float<T>(p[j][e] * (dp[j][e] - delta_s[qi]));
      }
    }
    __syncwarp();
    warp_gemm<T, D / 8, kBlockN, false>(dk_acc, pw, kLdp, qs, kLd);
  }
  store_rows<T, D / 8>(dk + kv_off, row_stride, dk_acc, scale,
                       kv0 + warp * 16, Tkv);
  store_rows<T, D / 8>(dv + kv_off, row_stride, dv_acc, 1.f, kv0 + warp * 16,
                       Tkv);
}

// ---------------------------------------------------------------------------
// Launchers.

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Tq, int Tkv, float scale,
                       int causal, cudaStream_t stream) {
  constexpr int kPBufs = std::is_same<T, bf16>::value ? 2 : 1;  // hi, lo
  const size_t smem =
      (3 * tile_elems<T, D>() + kPBufs * warp_buf_elems<T>()) * sizeof(T);
  auto kernel = fa_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBlockM - 1) / kBlockM, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Tq, Tkv, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int B, int H, int Tq,
                          int Tkv, float scale, int causal,
                          cudaStream_t stream) {
  const size_t smem =
      (4 * tile_elems<T, D>() + warp_buf_elems<T>()) * sizeof(T);
  auto kernel = fa_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + kBlockM - 1) / kBlockM, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Tq, Tkv, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_dkv(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int B,
                           int H, int Tq, int Tkv, float scale, int causal,
                           cudaStream_t stream) {
  const size_t smem =
      (4 * tile_elems<T, D>() + warp_buf_elems<T>()) * sizeof(T) +
      2 * kBlockN * sizeof(float);
  auto kernel = fa_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tkv + kBlockM - 1) / kBlockM, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tkv, scale, causal);
  return cudaGetLastError();
}

// dtype codes shared with ray_tpu_torch/ops/attention.py.
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

}  // namespace

// Returns the launch for a supported (dtype, head_dim) with T and D bound,
// or cudaErrorInvalidValue for any other pair.
#define RTT_DISPATCH(dtype, head_dim, ...)                 \
  do {                                                     \
    if ((dtype) == kBFloat16 && (head_dim) == 64) {        \
      using T = bf16;                                      \
      constexpr int D = 64;                                \
      return __VA_ARGS__;                                  \
    }                                                      \
    if ((dtype) == kBFloat16 && (head_dim) == 128) {       \
      using T = bf16;                                      \
      constexpr int D = 128;                               \
      return __VA_ARGS__;                                  \
    }                                                      \
    if ((dtype) == kFloat32 && (head_dim) == 64) {         \
      using T = float;                                     \
      constexpr int D = 64;                                \
      return __VA_ARGS__;                                  \
    }                                                      \
    if ((dtype) == kFloat32 && (head_dim) == 128) {        \
      using T = float;                                     \
      constexpr int D = 128;                               \
      return __VA_ARGS__;                                  \
    }                                                      \
    return cudaErrorInvalidValue;                          \
  } while (0)

extern "C" {

// Each entry point returns the cudaError_t of the launch (0 on success).

int rtt_flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                  const void* v, void* o, void* lse, int B, int H, int Tq,
                  int Tkv, float scale, int causal, void* stream) {
  RTT_DISPATCH(dtype, head_dim,
               launch_fwd<T, D>(q, k, v, o, lse, B, H, Tq, Tkv, scale, causal,
                                static_cast<cudaStream_t>(stream)));
}

int rtt_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                     const void* v, const void* dout, const void* lse,
                     const void* delta, void* dq, int B, int H, int Tq,
                     int Tkv, float scale, int causal, void* stream) {
  RTT_DISPATCH(dtype, head_dim,
               launch_bwd_dq<T, D>(q, k, v, dout, lse, delta, dq, B, H, Tq,
                                   Tkv, scale, causal,
                                   static_cast<cudaStream_t>(stream)));
}

int rtt_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                      const void* v, const void* dout, const void* lse,
                      const void* delta, void* dk, void* dv, int B, int H,
                      int Tq, int Tkv, float scale, int causal,
                      void* stream) {
  RTT_DISPATCH(dtype, head_dim,
               launch_bwd_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, B, H,
                                    Tq, Tkv, scale, causal,
                                    static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
