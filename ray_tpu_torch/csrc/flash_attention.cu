// Flash attention for Hopper (sm_90a): the forward kernel and the two
// backward kernels (dq; dk and dv), with a plain C interface for ctypes.
//
// Replaces the three Pallas kernels of ray_tpu/ops/attention.py:
//   fa_fwd_wgmma_kernel     <- _fa_kernel      (online-softmax forward, emits lse)
//   fa_bwd_dq_wgmma_kernel  <- _bwd_dq_kernel  (dq accumulated over kv tiles)
//   fa_bwd_dkv_wgmma_kernel <- _bwd_dkv_kernel (dk, dv accumulated over q tiles)
// fp32 inputs run fa_fwd_kernel, fa_bwd_dq_kernel and fa_bwd_dkv_kernel,
// SIMT versions of the three (TF32 would not hold fp32's tolerance).
//
// Layout. q, k, v, o, do and the gradients are contiguous (B, T, H, D)
// tensors, read in place through their strides (no folded copy); lse and
// delta are plain (B*H, T) fp32 arrays. Rows past T read as zero (TMA
// bounds the T dimension; the SIMT kernels zero-fill) and are masked out of
// every score, so any T >= 1 runs in the kernel.
//
// Design of the bf16 kernels. A block owns 128 rows (q rows in the
// forward and dq, kv rows in dk/dv) and loops over the other axis,
// which the TPU runs as its sequential grid dimension. It has three
// warpgroups: two consumers of 64 rows each, and a producer whose first
// warp issues every load (setmaxnreg gives its registers to the
// consumers). The producer copies tiles with TMA (128-byte swizzle, 64
// columns a box, so D = 128 is two boxes) into a ring of two stages with
// full/empty mbarriers; the tile that stays (Q, Q and dO, or K and V) is
// loaded once. Consumers run every product as wgmma (bf16 in, fp32
// accumulate): scores with both operands K-major in shared memory, and the
// second product with its A operand (P, P^T, dS or dS^T) taken from
// registers, converted in place from the scores' accumulator fragment, and
// B (V, dO, K or Q) read MN-major. No probability goes through shared
// memory. The forward and dq issue their heaviest causal q tiles first.
//
// Precision of P. `_fa_kernel` upcasts v to fp32, so its P.V product takes
// P in fp32; the backward kernels cast P and dS to the input dtype before
// their products. The forward keeps P's precision with bf16 inputs by
// splitting it into hi = bf16(p) and lo = bf16(p - hi) and running two
// wgmmas that share V's descriptor: hi + lo carries 16 of p's 24 mantissa
// bits, and what is dropped is below 2^-17 |p|. The backward kernels round
// P and dS to bf16, as their Pallas counterparts do.
//
// Bound. At the bench-350m shape (B 8, T 2048, H 16, D 64, causal) each
// kernel does ~130-270 FLOP per byte it must move, below the H100's ~295
// FLOP/byte ridge, so an ideal kernel sits near both roofs; the forward's
// hi/lo split makes its tensor-core work three products, not two. The
// wgmma kernels are bound by the work between their products: for each
// 128 x 128 forward tile the block takes 16384 exp2 on the special-function
// units (16 a clock per SM, ~1000 clocks) and, for hi and lo, two
// conversions to bf16 per pair of p, against ~1500 clocks of wgmma; a
// warpgroup's products wait for its own softmax, and only the other
// consumer warpgroup fills the tensor cores meanwhile. The causal skip
// (tiles above the diagonal are never loaded) halves the work, as in the
// TPU kernels. dq has the forward's three products and exp2 count per
// tile, but no running max or rescale and one conversion to bf16 per pair.
//
// Arithmetic follows the Pallas kernels: scores in fp32, the scale applied
// before masking, masked scores set to -1e30 (not -inf, so a fully masked
// row never forms exp(-inf - -inf)), fp32 accumulation. The bf16 kernels
// take exponentials as exp2 with log2(e) folded into the argument.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockM = 64;  // rows of the tile a SIMT block owns
constexpr int kBlockN = 64;  // rows of each tile the SIMT block loops over
constexpr int kWarps = 4;    // each warp owns 16 of the kBlockM rows
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

// The SIMT kernels run fp32 only; bf16 runs the wgmma kernels.
template <typename T>
struct Traits;
template <>
struct Traits<float> {
  static constexpr int kPad = 4;  // row pad (elements) against bank conflicts
  static constexpr int kVec = 4;  // elements per 16-byte load
};

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

// One warp: acc (16 x 8*NT, fragment layout) += A (16 x K) . B (K x 8*NT).
// A is row-major at `a` (row stride lda). B is read as b[n*ldb + k] when
// kNK (the n-major tile, e.g. K for Q.K^T) and as b[k*ldb + n] otherwise.
// Fragment entry acc[j][e] is row g + 8*(e/2), column 8*j + 2*t + e%2, where
// g = lane/4 and t = lane%4.
template <int NT, int K, bool kNK>
__device__ __forceinline__ void warp_gemm(float (*acc)[4], const float* a,
                                          int lda, const float* b, int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
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
            acc[j][e] * scale;
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
// SIMT forward (fp32). Grid (ceil(Tq/64), B*H). The kv sweep that the TPU
// runs as its sequential grid axis is the loop over n0, with the running
// max m, denominator l and accumulator in registers.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, int H, int Tq, int Tkv,
                  float scale, int causal) {
  static_assert(std::is_same<T, float>::value,
                "bf16 runs fa_fwd_wgmma_kernel, which keeps P in fp32");
  constexpr int kLd = D + Traits<T>::kPad;
  constexpr int kLdp = kBlockN + Traits<T>::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + tile_elems<T, D>();
  T* vs = ks + tile_elems<T, D>();
  T* ps = vs + tile_elems<T, D>();

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
    warp_gemm<kBlockN / 8, D, true>(s, qw, kLd, ks, kLd);

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
        pw[(g + 8 * (e >> 1)) * kLdp + j * 8 + 2 * t + (e & 1)] = p;
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
    warp_gemm<D / 8, kBlockN, false>(acc, pw, kLdp, vs, kLd);
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
// SIMT dq (fp32). Grid (ceil(Tq/64), B*H). The block owns a q tile and
// loops over the live kv tiles, dq in registers.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     int H, int Tq, int Tkv, float scale, int causal) {
  static_assert(std::is_same<T, float>::value,
                "bf16 runs fa_bwd_dq_wgmma_kernel");
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
    warp_gemm<kBlockN / 8, D, true>(s, qw, kLd, ks, kLd);
    warp_gemm<kBlockN / 8, D, true>(dp, dow, kLd, vs, kLd);
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
            p * (dp[j][e] - delta_r[r]);
      }
    }
    __syncwarp();
    warp_gemm<D / 8, kBlockN, false>(acc, dsw, kLdp, ks, kLd);
    __syncwarp();
  }
  store_rows<T, D / 8>(dq + q_off, row_stride, acc, scale, q0 + warp * 16, Tq);
}

// ---------------------------------------------------------------------------
// SIMT dk, dv (fp32). Grid (ceil(Tkv/64), B*H). The block owns a kv tile
// and loops over the live q tiles, dk and dv in registers. Each warp
// computes the transposed scores S^T = K.Q^T for its 16 kv rows, so P^T and
// dS^T come out in the layout the dv and dk products need.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Tq, int Tkv, float scale,
                      int causal) {
  static_assert(std::is_same<T, float>::value,
                "bf16 runs fa_bwd_dkv_wgmma_kernel");
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
    warp_gemm<kBlockN / 8, D, true>(p, kw, kLd, qs, kLd);
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
        pw[(g + 8 * (e >> 1)) * kLdp + qi] = p[j][e];
      }
    }
    __syncwarp();
    warp_gemm<D / 8, kBlockN, false>(dv_acc, pw, kLdp, dos, kLd);

    float dp[kBlockN / 8][4];
    zero<kBlockN / 8>(dp);
    warp_gemm<kBlockN / 8, D, true>(dp, vw, kLd, dos, kLd);
    __syncwarp();  // every lane is done reading P^T before dS^T replaces it
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1);
        pw[(g + 8 * (e >> 1)) * kLdp + qi] =
            p[j][e] * (dp[j][e] - delta_s[qi]);
      }
    }
    __syncwarp();
    warp_gemm<D / 8, kBlockN, false>(dk_acc, pw, kLdp, qs, kLd);
  }
  store_rows<T, D / 8>(dk + kv_off, row_stride, dk_acc, scale,
                       kv0 + warp * 16, Tkv);
  store_rows<T, D / 8>(dv + kv_off, row_stride, dv_acc, 1.f, kv0 + warp * 16,
                       Tkv);
}

// ---------------------------------------------------------------------------
// Hopper building blocks for the bf16 kernels: mbarriers, TMA, wgmma.

constexpr int kWgRows = 64;       // rows of one consumer's wgmma tile
constexpr int kConsumers = 2;     // consumer warpgroups a block
constexpr int kTileRows = kWgRows * kConsumers;  // rows a block owns
constexpr int kWgThreads = 128;
constexpr int kSm90Threads = (kConsumers + 1) * kWgThreads;  // + producer
constexpr int kProducerWarp = kConsumers * 4;  // first warp of the producer
constexpr int kStages = 2;        // TMA ring depth
constexpr int kFwdN = 128;        // kv rows of a forward tile
constexpr int kDkvQ = 64;         // q rows of a dk/dv tile
// kv rows of a dq tile. At 128, S and dP (64 floats a thread each) beside
// dq and the dS fragments overflow a consumer's 240 registers even at D 64.
constexpr int kDqN = 64;
constexpr int kBoxCols = 64;      // 128 bytes: the swizzle's span
constexpr int kBoxRowBytes = kBoxCols * 2;
// setmaxnreg: 128 x 24 + 256 x 240 = 384 x 168, the register file at entry.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
// Arrives and adds `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// Waits until the phase of parity `parity` has completed. A pipeline that
// never completes traps after 10 s (a launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - start > 10000000000ull) __trap();
  }
}

// One box of a 4-D tensor map (D, H, T, B) into shared memory; completion
// is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int h, int t0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0),
         "r"(h), "r"(t0), "r"(b)
      : "memory");
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits for all but the last committed group.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Keeps registers that an in-flight wgmma reads or writes in place until
// the wait before this call: the compiler sees them as read and written
// here, so it neither reuses nor moves them across the wait.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a tile at `addr`, 128-byte swizzle:
// eight 128-byte rows make a 1024-byte group. K-major tiles (rows x D, D
// contiguous) step along K inside a row; MN-major tiles (the product's K
// runs down the rows, N along D) step along N from one 64-column box to the
// next, `box` bytes apart. The descriptor is opaque to the compiler, so it
// derives each slice's descriptor where the wgmma takes it instead of
// holding all of them in registers across the tile loop.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr, uint32_t box,
                                              bool mn_major) {
  uint64_t desc = static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
                  static_cast<uint64_t>((mn_major ? box : 16) >> 4) << 16 |
                  static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
  asm volatile("" : "+l"(desc));
  return desc;
}
// The k16 slice kk of a K-major tile stored as 64-column boxes of `box`
// bytes: 32 bytes further along the row, the next box every four slices.
__device__ __forceinline__ uint64_t desc_k(uint64_t tile, int kk,
                                           uint32_t box) {
  return tile + (((kk >> 2) * box + (kk & 3) * 32) >> 4);
}
// The k16 slice kk of an MN-major tile: rows 16kk.. .
__device__ __forceinline__ uint64_t desc_mn(uint64_t tile, int kk) {
  return tile + ((kk * 16 * kBoxRowBytes) >> 4);
}

#define RTT_F8(d, i)                                                  \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define RTT_F32(d) RTT_F8(d, 0), RTT_F8(d, 8), RTT_F8(d, 16), RTT_F8(d, 24)
#define RTT_F64(d)                                                    \
  RTT_F8(d, 0), RTT_F8(d, 8), RTT_F8(d, 16), RTT_F8(d, 24), RTT_F8(d, 32), \
      RTT_F8(d, 40), RTT_F8(d, 48), RTT_F8(d, 56)

// d (m64 x N, fp32) = A.B (+ d if `accumulate`): m64nNk16 with A and B
// K-major in shared memory. Accumulator register 4j + e holds row
// 16*warp + lane/4 + 8*(e/2), column 8j + 2*(lane%4) + e%2.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RTT_F32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : RTT_F64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
// d += A.B: m64nNk16 with A in registers (the m16n8k16 A fragment of each
// warp's 16 rows) and B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RTT_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RTT_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// Register i of the A fragment of k16 slice kk, taken from an accumulator
// laid out as wgmma's: chunk j = 2kk + i/2, rows e/2 = i%2.
__device__ __forceinline__ constexpr int frag_src(int kk, int i) {
  return 4 * (2 * kk + (i >> 1)) + 2 * (i & 1);
}

// Writes this thread's part of a 64 x D accumulator, times `scale`, as bf16
// to rows row0 and row0 + 8 of a (T, H, D)-strided slice, below `rows`.
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, int64_t row_stride,
                                          const float (&acc)[D / 2],
                                          const float (&scale)[2], int row0,
                                          int t, int rows) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
    bf16* out = dst + row * row_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out + 8 * j) = bf16x2(
          acc[4 * j + 2 * r] * scale[r], acc[4 * j + 2 * r + 1] * scale[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward. Grid (ceil(Tq/128), B*H); q tiles run last to first, so
// the heaviest causal tiles start first. Replaces _fa_kernel: the kv sweep
// is the loop over tiles, with the running max m (log2 units), denominator
// l and accumulator in registers.
template <int D>
struct FwdSmem {  // byte offsets from a 1024-aligned base
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kKvTile = kFwdN * D * 2;
  static constexpr uint32_t kK = kTileRows * D * 2;
  static constexpr uint32_t kV = kK + kStages * kKvTile;
  static constexpr uint32_t kBars = kV + kStages * kKvTile;
  static constexpr uint32_t kBytes = kBars + (1 + 2 * kStages) * 8;
};

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    fa_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap map_q,
                        __grid_constant__ const CUtensorMap map_k,
                        __grid_constant__ const CUtensorMap map_v,
                        bf16* __restrict__ o, float* __restrict__ lse, int H,
                        int Tq, int Tkv, float scale, int causal) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_bar = smem + L::kBars;
  const uint32_t full_bar = q_bar + 8;                // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * kStages;  // + 8 * stage

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTileRows;
  // Causal: a kv tile is live iff its first row <= the q tile's last row.
  const int kv_end = causal ? min(Tkv, q0 + kTileRows) : Tkv;
  const int n_tiles = (kv_end + kFwdN - 1) / kFwdN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers * kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kProducerWarp && lane == 0) {
      mbar_expect_tx(q_bar, kTileRows * D * 2);
      for (int c = 0; c < D / kBoxCols; ++c) {
        tma_load(smem + L::kQ + c * kTileRows * kBoxRowBytes, &map_q, q_bar,
                 c * kBoxCols, h, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        mbar_wait(empty_bar + 8 * st, ((it / kStages) & 1) ^ 1);
        const uint32_t full = full_bar + 8 * st;
        mbar_expect_tx(full, 2 * L::kKvTile);
        for (int c = 0; c < D / kBoxCols; ++c) {
          const uint32_t off = st * L::kKvTile + c * kFwdN * kBoxRowBytes;
          tma_load(smem + L::kK + off, &map_k, full, c * kBoxCols, h,
                   it * kFwdN, b);
          tma_load(smem + L::kV + off, &map_v, full, c * kBoxCols, h,
                   it * kFwdN, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4;
    const int t = lane % 4;
    const int q_first = q0 + wg * kWgRows;  // this warpgroup's first row
    const int row0 = q_first + (warp % 4) * 16 + lane / 4;  // and row0 + 8
    const float scale2 = scale * kLog2e;
    const uint32_t q_tile = smem + L::kQ + wg * kWgRows * kBoxRowBytes;
    constexpr uint32_t kQBox = kTileRows * kBoxRowBytes;
    constexpr uint32_t kKvBox = kFwdN * kBoxRowBytes;

    float o_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    mbar_wait(q_bar, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int n0 = it * kFwdN;
      const uint32_t k_tile = smem + L::kK + st * L::kKvTile;
      const uint32_t v_tile = smem + L::kV + st * L::kKvTile;
      mbar_wait(full_bar + 8 * st, (it / kStages) & 1);

      float s_acc[kFwdN / 2];
      const uint64_t q_desc = tile_desc(q_tile, kQBox, false);
      const uint64_t k_desc = tile_desc(k_tile, kKvBox, false);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(s_acc, desc_k(q_desc, kk, kQBox), desc_k(k_desc, kk, kKvBox),
                 kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(s_acc);

      // Scale, then mask: only tiles on the diagonal or the ragged edge.
      const bool edge =
          (causal && n0 + kFwdN - 1 > q_first) || n0 + kFwdN > Tkv;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kFwdN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s_acc[4 * j + e] * scale2;
          if (edge) {
            const int row = row0 + 8 * (e >> 1);
            const int col = n0 + 8 * j + 2 * t + (e & 1);
            if (col >= Tkv || (causal && col > row)) x = kNegInf;
          }
          s_acc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], row_max(mx[r]));
        alpha[r] = exp2_approx(m[r] - m_new);
        m[r] = m_new;
      }
      // P into the A fragments of P.V as hi = bf16(p), lo = bf16(p - hi).
      float sum[2] = {0.f, 0.f};
      uint32_t p_hi[kFwdN / 16][4];
      uint32_t p_lo[kFwdN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kFwdN / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int src = frag_src(kk, i);
          const float p0 = exp2_approx(s_acc[src] - m[i & 1]);
          const float p1 = exp2_approx(s_acc[src + 1] - m[i & 1]);
          sum[i & 1] += p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[kk][i] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[kk][i] = bf16x2(p0 - hf.x, p1 - hf.y);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + row_sum(sum[r]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o_acc[4 * j + e] *= alpha[e >> 1];
      }

      const uint64_t v_tile_desc = tile_desc(v_tile, kKvBox, true);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdN / 16; ++kk) {
        const uint64_t v_desc = desc_mn(v_tile_desc, kk);
        wgmma_rs(o_acc, p_hi[kk], v_desc);
        wgmma_rs(o_acc, p_lo[kk], v_desc);
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(o_acc);
#pragma unroll
      for (int kk = 0; kk < kFwdN / 16; ++kk) {
        keep(p_hi[kk]);
        keep(p_lo[kk]);
      }
      mbar_arrive(empty_bar + 8 * st);
    }

    const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
    const int64_t row_stride = static_cast<int64_t>(H) * D;
    store_acc<D>(o + (static_cast<int64_t>(b) * Tq * H + h) * D, row_stride,
                 o_acc, inv_l, row0, t, Tq);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < Tq) {
          lse[static_cast<int64_t>(bh) * Tq + row] =
              (m[r] + log2f(l[r])) * kLn2;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dq. Grid (ceil(Tq/128), B*H); q tiles run last to first, so the
// heaviest causal tiles start first. Replaces _bwd_dq_kernel: the block
// keeps its Q and dO tile in shared memory and loops over the live kv
// tiles, dq in registers. Each consumer computes S = Q.K^T and dP = dO.V^T
// for its 64 q rows, forms dS = P (dP - delta) in the accumulators' layout
// and rounds it to bf16 into the A fragments of dS.K, which reads the same
// K tile MN-major. dq is summed in one place per q tile, in a fixed order:
// no atomics, so two launches give the same bits.
template <int D>
struct DqSmem {  // byte offsets from a 1024-aligned base
  static constexpr uint32_t kQTile = kTileRows * D * 2;
  static constexpr uint32_t kKvTile = kDqN * D * 2;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDo = kQTile;
  static constexpr uint32_t kK = 2 * kQTile;              // + stage * kKvTile
  static constexpr uint32_t kV = kK + kStages * kKvTile;  // + stage * kKvTile
  static constexpr uint32_t kBars = kV + kStages * kKvTile;
  static constexpr uint32_t kBytes = kBars + (1 + 2 * kStages) * 8;
};

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    fa_bwd_dq_wgmma_kernel(__grid_constant__ const CUtensorMap map_q,
                           __grid_constant__ const CUtensorMap map_k,
                           __grid_constant__ const CUtensorMap map_v,
                           __grid_constant__ const CUtensorMap map_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dq, int H, int Tq, int Tkv,
                           float scale, int causal) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_bar = smem + L::kBars;
  const uint32_t full_bar = q_bar + 8;                // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * kStages;  // + 8 * stage

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTileRows;
  // Causal: a kv tile is live iff its first row <= the q tile's last row.
  const int kv_end = causal ? min(Tkv, q0 + kTileRows) : Tkv;
  const int n_tiles = (kv_end + kDqN - 1) / kDqN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers * kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kProducerWarp && lane == 0) {
      mbar_expect_tx(q_bar, 2 * L::kQTile);
      for (int c = 0; c < D / kBoxCols; ++c) {
        const uint32_t off = c * kTileRows * kBoxRowBytes;
        tma_load(smem + L::kQ + off, &map_q, q_bar, c * kBoxCols, h, q0, b);
        tma_load(smem + L::kDo + off, &map_do, q_bar, c * kBoxCols, h, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        mbar_wait(empty_bar + 8 * st, ((it / kStages) & 1) ^ 1);
        const uint32_t full = full_bar + 8 * st;
        const int n0 = it * kDqN;
        mbar_expect_tx(full, 2 * L::kKvTile);
        for (int c = 0; c < D / kBoxCols; ++c) {
          const uint32_t off = st * L::kKvTile + c * kDqN * kBoxRowBytes;
          tma_load(smem + L::kK + off, &map_k, full, c * kBoxCols, h, n0, b);
          tma_load(smem + L::kV + off, &map_v, full, c * kBoxCols, h, n0, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4;
    const int t = lane % 4;
    const int q_first = q0 + wg * kWgRows;  // this warpgroup's first row
    const int row0 = q_first + (warp % 4) * 16 + lane / 4;  // and row0 + 8
    const float scale2 = scale * kLog2e;
    const uint32_t q_tile = smem + L::kQ + wg * kWgRows * kBoxRowBytes;
    const uint32_t do_tile = smem + L::kDo + wg * kWgRows * kBoxRowBytes;
    constexpr uint32_t kQBox = kTileRows * kBoxRowBytes;
    constexpr uint32_t kKvBox = kDqN * kBoxRowBytes;

    // lse (log2 units) and delta of this thread's two rows, 0 past Tq.
    float lse2[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const int64_t i = static_cast<int64_t>(bh) * Tq + row;
      lse2[r] = row < Tq ? lse[i] * kLog2e : 0.f;
      delta_r[r] = row < Tq ? delta[i] : 0.f;
    }
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    mbar_wait(q_bar, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int n0 = it * kDqN;
      const uint32_t k_tile = smem + L::kK + st * L::kKvTile;
      const uint32_t v_tile = smem + L::kV + st * L::kKvTile;
      const uint32_t empty = empty_bar + 8 * st;
      // Wait even for a tile this warpgroup skips: its arrival on the empty
      // barrier must fall in this tile's phase, not the previous one's.
      mbar_wait(full_bar + 8 * st, (it / kStages) & 1);
      // Causal: a tile wholly above this warpgroup's rows adds nothing.
      if (causal && n0 > q_first + kWgRows - 1) {
        mbar_arrive(empty);
        continue;
      }

      float s_acc[kDqN / 2];
      float dp_acc[kDqN / 2];
      const uint64_t q_desc = tile_desc(q_tile, kQBox, false);
      const uint64_t do_desc = tile_desc(do_tile, kQBox, false);
      const uint64_t k_desc = tile_desc(k_tile, kKvBox, false);
      const uint64_t v_desc = tile_desc(v_tile, kKvBox, false);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(s_acc, desc_k(q_desc, kk, kQBox), desc_k(k_desc, kk, kKvBox),
                 kk);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(dp_acc, desc_k(do_desc, kk, kQBox),
                 desc_k(v_desc, kk, kKvBox), kk);
      }
      wgmma_commit();
      // S and dP are two commit groups: P's exp2 runs while dP's wgmmas do.
      wgmma_wait_one();
      keep(s_acc);

      // P = exp(scale*S - lse) after masking (diagonal and ragged tiles
      // only).
      const bool edge =
          (causal && n0 + kDqN - 1 > q_first) || n0 + kDqN > Tkv;
#pragma unroll
      for (int j = 0; j < kDqN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s_acc[4 * j + e] * scale2;
          if (edge) {
            const int row = row0 + 8 * (e >> 1);
            const int col = n0 + 8 * j + 2 * t + (e & 1);
            if (col >= Tkv || (causal && col > row)) x = kNegInf;
          }
          s_acc[4 * j + e] = exp2_approx(x - lse2[e >> 1]);
        }
      }
      wgmma_wait_all();
      keep(dp_acc);
      // dS = P (dP - delta) rounded to bf16 into dS.K's A fragments.
      uint32_t ds_frag[kDqN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDqN / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int src = frag_src(kk, i);
          const float d = delta_r[i & 1];
          ds_frag[kk][i] = bf16x2(s_acc[src] * (dp_acc[src] - d),
                                  s_acc[src + 1] * (dp_acc[src + 1] - d));
        }
      }

      const uint64_t k_mn = tile_desc(k_tile, kKvBox, true);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqN / 16; ++kk) {
        wgmma_rs(dq_acc, ds_frag[kk], desc_mn(k_mn, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(dq_acc);
#pragma unroll
      for (int kk = 0; kk < kDqN / 16; ++kk) keep(ds_frag[kk]);
      mbar_arrive(empty);
    }

    const int64_t row_stride = static_cast<int64_t>(H) * D;
    const float dq_scale[2] = {scale, scale};
    store_acc<D>(dq + (static_cast<int64_t>(b) * Tq * H + h) * D, row_stride,
                 dq_acc, dq_scale, row0, t, Tq);
  }
}

// ---------------------------------------------------------------------------
// bf16 dk, dv. Grid (ceil(Tkv/128), B*H); the first kv tiles, which meet
// the most causal q tiles, start first. Replaces _bwd_dkv_kernel: the
// block keeps its K and V tile in shared memory and loops over the live q
// tiles, dk and dv in registers. Each consumer computes the transposed
// scores S^T = K.Q^T and dP^T = V.dO^T for its 64 kv rows, so P^T and dS^T
// come out as the A fragments the dv and dk products take.
template <int D>
struct DkvSmem {  // byte offsets from a 1024-aligned base
  static constexpr uint32_t kKvTile = kTileRows * D * 2;
  static constexpr uint32_t kQTile = kDkvQ * D * 2;
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kKvTile;
  static constexpr uint32_t kQ = 2 * kKvTile;              // + stage * kQTile
  static constexpr uint32_t kDo = kQ + kStages * kQTile;   // + stage * kQTile
  static constexpr uint32_t kLse = kDo + kStages * kQTile;  // + stage * kDkvQ
  static constexpr uint32_t kDelta = kLse + kStages * kDkvQ * 4;
  static constexpr uint32_t kBars = kDelta + kStages * kDkvQ * 4;
  static constexpr uint32_t kBytes = kBars + (1 + 2 * kStages) * 8;
};

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    fa_bwd_dkv_wgmma_kernel(__grid_constant__ const CUtensorMap map_q,
                            __grid_constant__ const CUtensorMap map_k,
                            __grid_constant__ const CUtensorMap map_v,
                            __grid_constant__ const CUtensorMap map_do,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int H, int Tq, int Tkv, float scale, int causal) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* smem_ptr = smem_raw + (smem - smem_u32(smem_raw));
  float* lse_s = reinterpret_cast<float*>(smem_ptr + L::kLse);
  float* delta_s = reinterpret_cast<float*>(smem_ptr + L::kDelta);
  const uint32_t kv_bar = smem + L::kBars;
  const uint32_t full_bar = kv_bar + 8;               // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * kStages;  // + 8 * stage

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kv0 = blockIdx.x * kTileRows;
  // Causal: a q tile is live iff its last row >= the kv tile's first row.
  const int q_begin = causal ? (kv0 / kDkvQ) * kDkvQ : 0;
  const int n_tiles = Tq > q_begin ? (Tq - q_begin + kDkvQ - 1) / kDkvQ : 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 32);  // the producer warp's lanes
      mbar_init(empty_bar + 8 * s, kConsumers * kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp == kProducerWarp) {
      if (lane == 0) {
        mbar_expect_tx(kv_bar, 2 * L::kKvTile);
        for (int c = 0; c < D / kBoxCols; ++c) {
          const uint32_t off = c * kTileRows * kBoxRowBytes;
          tma_load(smem + L::kK + off, &map_k, kv_bar, c * kBoxCols, h, kv0, b);
          tma_load(smem + L::kV + off, &map_v, kv_bar, c * kBoxCols, h, kv0, b);
        }
      }
      const float* lse_bh = lse + static_cast<int64_t>(bh) * Tq;
      const float* delta_bh = delta + static_cast<int64_t>(bh) * Tq;
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const int q0 = q_begin + it * kDkvQ;
        mbar_wait(empty_bar + 8 * st, ((it / kStages) & 1) ^ 1);
        // lse and delta by plain loads (a T of any length), 0 past Tq.
        for (int i = lane; i < kDkvQ; i += 32) {
          const bool in = q0 + i < Tq;
          lse_s[st * kDkvQ + i] = in ? lse_bh[q0 + i] : 0.f;
          delta_s[st * kDkvQ + i] = in ? delta_bh[q0 + i] : 0.f;
        }
        const uint32_t full = full_bar + 8 * st;
        if (lane == 0) {
          mbar_expect_tx(full, 2 * L::kQTile);
          for (int c = 0; c < D / kBoxCols; ++c) {
            const uint32_t off = st * L::kQTile + c * kDkvQ * kBoxRowBytes;
            tma_load(smem + L::kQ + off, &map_q, full, c * kBoxCols, h, q0, b);
            tma_load(smem + L::kDo + off, &map_do, full, c * kBoxCols, h, q0, b);
          }
        } else {
          mbar_arrive(full);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4;
    const int t = lane % 4;
    const int kv_first = kv0 + wg * kWgRows;  // this warpgroup's first row
    const int row0 = kv_first + (warp % 4) * 16 + lane / 4;  // and row0 + 8
    const uint32_t k_tile = smem + L::kK + wg * kWgRows * kBoxRowBytes;
    const uint32_t v_tile = smem + L::kV + wg * kWgRows * kBoxRowBytes;
    constexpr uint32_t kKvBox = kTileRows * kBoxRowBytes;
    constexpr uint32_t kQBox = kDkvQ * kBoxRowBytes;

    float dk_acc[D / 2];
    float dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_bar, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int q0 = q_begin + it * kDkvQ;
      const uint32_t q_tile = smem + L::kQ + st * L::kQTile;
      const uint32_t do_tile = smem + L::kDo + st * L::kQTile;
      const float* lse_t = lse_s + st * kDkvQ;
      const float* delta_t = delta_s + st * kDkvQ;
      mbar_wait(full_bar + 8 * st, (it / kStages) & 1);

      float s_acc[kDkvQ / 2];
      float dp_acc[kDkvQ / 2];
      const uint64_t k_desc = tile_desc(k_tile, kKvBox, false);
      const uint64_t v_desc = tile_desc(v_tile, kKvBox, false);
      const uint64_t q_desc = tile_desc(q_tile, kQBox, false);
      const uint64_t do_desc = tile_desc(do_tile, kQBox, false);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(s_acc, desc_k(k_desc, kk, kKvBox), desc_k(q_desc, kk, kQBox),
                 kk);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss(dp_acc, desc_k(v_desc, kk, kKvBox),
                 desc_k(do_desc, kk, kQBox), kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(s_acc);
      keep(dp_acc);

      // P^T = exp(scale*S^T - lse[col]) after masking (diagonal and ragged
      // tiles only); dS^T = P^T (dP^T - delta[col]), from P^T in fp32.
      const bool edge =
          (causal && q0 < kv_first + kWgRows - 1) || q0 + kDkvQ > Tq;
#pragma unroll
      for (int j = 0; j < kDkvQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          float x = s_acc[4 * j + e] * scale;
          if (edge) {
            const int row = row0 + 8 * (e >> 1);
            if (q0 + c >= Tq || (causal && row > q0 + c)) x = kNegInf;
          }
          const float p = exp2_approx((x - lse_t[c]) * kLog2e);
          s_acc[4 * j + e] = p;
          dp_acc[4 * j + e] = p * (dp_acc[4 * j + e] - delta_t[c]);
        }
      }
      // P^T and dS^T rounded to bf16 into the A fragments of dv and dk.
      uint32_t p_frag[kDkvQ / 16][4];
      uint32_t ds_frag[kDkvQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDkvQ / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int src = frag_src(kk, i);
          p_frag[kk][i] = bf16x2(s_acc[src], s_acc[src + 1]);
          ds_frag[kk][i] = bf16x2(dp_acc[src], dp_acc[src + 1]);
        }
      }

      const uint64_t do_mn = tile_desc(do_tile, kQBox, true);
      const uint64_t q_mn = tile_desc(q_tile, kQBox, true);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDkvQ / 16; ++kk) {
        wgmma_rs(dv_acc, p_frag[kk], desc_mn(do_mn, kk));
      }
#pragma unroll
      for (int kk = 0; kk < kDkvQ / 16; ++kk) {
        wgmma_rs(dk_acc, ds_frag[kk], desc_mn(q_mn, kk));
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(dv_acc);
      keep(dk_acc);
#pragma unroll
      for (int kk = 0; kk < kDkvQ / 16; ++kk) {
        keep(p_frag[kk]);
        keep(ds_frag[kk]);
      }
      mbar_arrive(empty_bar + 8 * st);
    }

    const int64_t row_stride = static_cast<int64_t>(H) * D;
    const int64_t kv_off = (static_cast<int64_t>(b) * Tkv * H + h) * D;
    const float dk_scale[2] = {scale, scale};
    const float one[2] = {1.f, 1.f};
    store_acc<D>(dk + kv_off, row_stride, dk_acc, dk_scale, row0, t, Tkv);
    store_acc<D>(dv + kv_off, row_stride, dv_acc, one, row0, t, Tkv);
  }
}

// ---------------------------------------------------------------------------
// Launchers.

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has
// already loaded, so the library needs no link to it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A TMA map over a contiguous (B, T, H, D) bf16 tensor as the 4-D array
// (D, H, T, B). A box is 64 columns of one head by `rows` rows of T; T is
// bounded, so rows past it read as zero and never reach the next batch.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int T, int H,
                     int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {dims[0] * 2, dims[0] * dims[1] * 2,
                                 dims[0] * dims[1] * dims[2] * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
size_t fwd_wgmma_smem() {
  return FwdSmem<D>::kBytes + 1024;  // + the base's alignment to 1024
}
template <int D>
size_t dq_wgmma_smem() {
  return DqSmem<D>::kBytes + 1024;
}
template <int D>
size_t dkv_wgmma_smem() {
  return DkvSmem<D>::kBytes + 1024;
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int H, int Tq, int Tkv, float scale,
                       int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    CUtensorMap mq, mk, mv;
    cudaError_t err = make_map(&mq, q, B, Tq, H, D, kTileRows);
    if (err == cudaSuccess) err = make_map(&mk, k, B, Tkv, H, D, kFwdN);
    if (err == cudaSuccess) err = make_map(&mv, v, B, Tkv, H, D, kFwdN);
    if (err != cudaSuccess) return err;
    const size_t smem = fwd_wgmma_smem<D>();
    auto kernel = fa_fwd_wgmma_kernel<D>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Tq + kTileRows - 1) / kTileRows, B * H);
    kernel<<<grid, kSm90Threads, smem, stream>>>(
        mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), H, Tq,
        Tkv, scale, causal);
  } else {
    const size_t smem =
        (3 * tile_elems<T, D>() + warp_buf_elems<T>()) * sizeof(T);
    auto kernel = fa_fwd_kernel<T, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Tq + kBlockM - 1) / kBlockM, B * H);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
        H, Tq, Tkv, scale, causal);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int B, int H, int Tq,
                          int Tkv, float scale, int causal,
                          cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    CUtensorMap mq, mk, mv, mdo;
    cudaError_t err = make_map(&mq, q, B, Tq, H, D, kTileRows);
    if (err == cudaSuccess) err = make_map(&mdo, dout, B, Tq, H, D, kTileRows);
    if (err == cudaSuccess) err = make_map(&mk, k, B, Tkv, H, D, kDqN);
    if (err == cudaSuccess) err = make_map(&mv, v, B, Tkv, H, D, kDqN);
    if (err != cudaSuccess) return err;
    const size_t smem = dq_wgmma_smem<D>();
    auto kernel = fa_bwd_dq_wgmma_kernel<D>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Tq + kTileRows - 1) / kTileRows, B * H);
    kernel<<<grid, kSm90Threads, smem, stream>>>(
        mq, mk, mv, mdo, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dq), H, Tq, Tkv,
        scale, causal);
  } else {
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
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_dkv(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int B,
                           int H, int Tq, int Tkv, float scale, int causal,
                           cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    CUtensorMap mq, mk, mv, mdo;
    cudaError_t err = make_map(&mq, q, B, Tq, H, D, kDkvQ);
    if (err == cudaSuccess) err = make_map(&mdo, dout, B, Tq, H, D, kDkvQ);
    if (err == cudaSuccess) err = make_map(&mk, k, B, Tkv, H, D, kTileRows);
    if (err == cudaSuccess) err = make_map(&mv, v, B, Tkv, H, D, kTileRows);
    if (err != cudaSuccess) return err;
    const size_t smem = dkv_wgmma_smem<D>();
    auto kernel = fa_bwd_dkv_wgmma_kernel<D>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Tkv + kTileRows - 1) / kTileRows, B * H);
    kernel<<<grid, kSm90Threads, smem, stream>>>(
        mq, mk, mv, mdo, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), H, Tq, Tkv, scale, causal);
  } else {
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
  }
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

// Dynamic shared memory, in bytes, of the bf16 wgmma kernels: kernel 0 is
// the forward, 1 dk/dv, 2 dq; -1 for any other (kernel, head_dim).
long long rtt_flash_wgmma_smem(int kernel, int head_dim) {
  if (kernel == 0 && head_dim == 64) return fwd_wgmma_smem<64>();
  if (kernel == 0 && head_dim == 128) return fwd_wgmma_smem<128>();
  if (kernel == 1 && head_dim == 64) return dkv_wgmma_smem<64>();
  if (kernel == 1 && head_dim == 128) return dkv_wgmma_smem<128>();
  if (kernel == 2 && head_dim == 64) return dq_wgmma_smem<64>();
  if (kernel == 2 && head_dim == 128) return dq_wgmma_smem<128>();
  return -1;
}

}  // extern "C"
