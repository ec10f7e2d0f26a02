// Flash attention for Hopper (sm_90a): the forward, the dQ pass and the
// dK/dV pass, on [B*H, S, D] row-major tensors of fp32 or bf16.
//
// Replaces the three Pallas TPU kernels of
// paddle_operator_tpu/ops/attention_pallas.py:
//   flash_fwd_*  <- _fwd_kernel  (launched by _flash_fwd)
//   flash_dq_*   <- _dq_kernel   (launched by _flash_bwd)
//   flash_dkv_*  <- _dkv_kernel  (launched by _flash_bwd)
//
// What they compute, per (batch*head) and with NEG_INF = -1e30 above the
// diagonal when causal:
//   fwd: s = scale * q k^T; O = softmax(s) v; LSE = m + log(l), by an
//        online softmax over K/V tiles (running max m, denominator l);
//   dq:  p = exp(scale * q k^T - LSE); ds = p * (dO v^T - delta);
//        dQ = scale * ds k;
//   dkv: dV = p^T dO; dK = scale * ds^T q.
// delta = rowsum(dO * O) (minus the LSE cotangent) is computed outside, as
// in the JAX package.
//
// Bound: at the training shape (S = 1024, D = 64, bf16) each kernel does
// 2-4 products of 2*S*S*D/2 flops per head against 4-6 tensors of S*D
// bf16 elements (plus LSE and delta), about 250-340 flops per byte: at the
// card's bf16 balance point (about 295), so the least time is the larger
// of the bf16 tensor-core time and the HBM time, within 20 % of each
// other.
//
// Two designs, by input type:
//
// bf16 (flash_fwd_mma_kernel, flash_dq_mma_kernel, flash_dkv_mma_kernel):
// tensor cores. Products are mma.sync.m16n8k16 with bf16 operands and fp32
// accumulators, operands come from shared memory by ldmatrix (.trans where
// the operand is k-major), and tiles arrive by cp.async into a two-stage
// ring, the next tile in flight while the current one is multiplied.
//  * Four warps a block; each warp owns 16 rows of the block's 64 (query
//    rows in the forward and dQ, key rows in dK/dV) and keeps its
//    accumulators in registers. Row max and sum are over the 4 lanes of a
//    quad.
//  * q k^T and dO v^T have bf16 operands: exact products, fp32 sums. The
//    score is scaled after the product (at D = 64 the scale is 0.125 and
//    this equals scaling q first bit for bit; elsewhere it differs by one
//    fp32 rounding).
//  * P and dS are fp32. One bf16 rounding of them moves bf16 outputs by
//    tens of ulps, so each is split into hi = bf16(x) and lo = bf16(x -
//    hi), and both go through the tensor cores into one fp32 accumulator
//    (hi + lo keeps 16 bits of x, error <= 2^-17 |x|): within one bf16 ulp
//    of the fp32 plain versions, for 3/2 the products of a single rounding
//    in the forward and dK/dV and 4/3 in dQ (q k^T, dO v^T, then dS k
//    twice).
//  * The accumulator fragment of a score product is the A fragment of the
//    next product (two m16n8 C tiles are one m16k16 A tile), so P, dS and
//    their transposes never leave registers. dQ takes dS as it comes out of
//    the score products and multiplies it by the same K tile, read with
//    ldmatrix.trans as V is for P v in the forward. dK/dV compute S^T = K
//    Q^T and dP^T = V dO^T directly, so their fragments are the A operands
//    of dV += P^T dO and dK += dS^T Q; LSE and delta are read per column
//    from shared memory (per row from global memory, once, in dQ).
//  * Rows are padded by 8 bf16 (16 bytes) in shared memory, so the 8 rows
//    an ldmatrix reads fall in distinct banks.
//  * Registers: Q (and dO in dQ) stay in registers as A fragments where
//    they fit: Q up to D = 128, dO at D = 64; elsewhere they are read from
//    shared memory at each k-step. D = 256: the forward and dQ take 32-key
//    tiles; dK/dV take 32-query tiles and split the output columns over
//    two blocks (grid.z), each recomputing P and dS, so that a thread's
//    accumulators stay at 128 floats.
//
// fp32 (flash_*_kernel<float, D>): the first, simple design, on fp32 CUDA
// cores (67 TFLOP/s at best), bound by its own instruction issue. fp32
// inputs stay here: they hold a 2e-5 absolute gate that TF32 could not.
//  * 256 threads as a 16 x 16 grid (ty, tx). A score tile [R, C] is held
//    in registers, thread (ty, tx) owning rows ty + 16*i and columns
//    tx + 16*j; an output tile [R, D] likewise owns rows ty + 16*i and
//    columns tx + 16*j. The 16 threads of a row are 16 lanes of one warp,
//    so row max and row sum are warp shuffles, and a row's softmax state
//    (m, l, the correction) lives in the registers that own its outputs.
//    The forward scales q before the product, as the TPU kernel does.
//  * Tiles are staged from global memory through shared memory, row pitch
//    D + 1 where a warp reads down a column (no bank conflicts). A tile of
//    R rows is R*D contiguous elements, so loads are coalesced 4-element
//    vectors.
//  * Tiles: 64 x 64 for D in {64, 128}, 32 x 32 for D = 256, so that every
//    kernel's shared memory fits in one SM (at most 166 KB).
//
// Common to both:
//  * One block per (q-tile, b*h) for fwd and dq, which loop over K/V
//    tiles; causal loops end at the diagonal tile and only tiles that
//    reach above the diagonal are masked. Heavy causal q-tiles are
//    scheduled first.
//  * The TPU's dK/dV pass walks a sequential (bh, kv-tile, q-tile) grid
//    and carries dK/dV in VMEM scratch. CUDA blocks run in no order, so
//    one block per (kv-tile, b*h) loops over the q-tiles itself, from the
//    first one that reaches the diagonal, and keeps dK/dV in registers:
//    no atomics, one write, a deterministic result.
//  * LSE and delta are [B*H, S] fp32: the TPU's 128-lane replication
//    (MIN_BLOCK) is a layout rule of that chip and is dropped.
//  * Shared memory above 48 KB is set with
//    cudaFuncAttributeMaxDynamicSharedMemorySize. S must be a multiple of
//    the tiles; the Python wrapper checks S % 128 == 0 and D.
//
// Every entry point launches on the given stream, allocates and
// synchronises nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape or type it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // ops/attention.py NEG_INF
constexpr int kThreads = 256;      // 16 x 16

// ---- SIMT loads and stores (fp32) -------------------------------------------

__device__ __forceinline__ void load4(const float* p, float* out) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Stage a tile of ROWS contiguous rows of D elements from src into dst
// (fp32, row pitch PITCH), each element multiplied by mul (1 keeps it
// exact).
template <typename T, int ROWS, int D, int PITCH>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          float mul) {
  constexpr int kGroups = ROWS * D / 4;
  static_assert(kGroups % kThreads == 0, "tile does not split evenly");
#pragma unroll 4
  for (int g = threadIdx.x; g < kGroups; g += kThreads) {
    const int e = g * 4;
    float v[4];
    load4(src + e, v);
    float* d = dst + (e / D) * PITCH + (e % D);
    d[0] = v[0] * mul; d[1] = v[1] * mul; d[2] = v[2] * mul; d[3] = v[3] * mul;
  }
}

// max / sum over the 16 lanes that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

// ---- tiles per head dim ---------------------------------------------------

template <int D> struct Tiles { static constexpr int Q = 64, K = 64; };
template <> struct Tiles<256> { static constexpr int Q = 32, K = 32; };

template <int D> constexpr size_t fwd_smem_floats() {
  constexpr int BQ = Tiles<D>::Q, BK = Tiles<D>::K;
  return size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
         size_t(BQ) * (BK + 1);
}

template <int D> constexpr size_t dq_smem_floats() {
  constexpr int BQ = Tiles<D>::Q, BK = Tiles<D>::K;
  return 2 * size_t(BQ) * (D + 1) + 2 * size_t(BK) * (D + 1) +
         size_t(BQ) * (BK + 1);
}

template <int D> constexpr size_t dkv_smem_floats() {
  constexpr int BQ = Tiles<D>::Q, BK = Tiles<D>::K;
  return 2 * size_t(BK) * (D + 1) + 2 * size_t(BQ) * (D + 1) +
         2 * size_t(BK) * (BQ + 1) + 2 * size_t(BQ);
}

// ---- B2a: forward ---------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, float scale, int causal) {
  constexpr int BQ = Tiles<D>::Q, BK = Tiles<D>::K;
  constexpr int QP = D + 1, KP = D + 1, VP = D, PP = BK + 1;
  constexpr int RM = BQ / 16, CN = BK / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QP;
  float* Vs = Ks + BK * KP;
  float* Ps = Vs + BK * VP;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int qi = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int q0 = qi * BQ;
  const size_t base = size_t(blockIdx.y) * S * D;

  load_tile<T, BQ, D, QP>(Qs, q + base + size_t(q0) * D, scale);

  float acc[RM][CD], m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = causal ? (q0 + BQ + BK - 1) / BK : S / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers of Ks, Vs, Ps are done
    load_tile<T, BK, D, KP>(Ks, k + base + size_t(k0) * D, 1.f);
    load_tile<T, BK, D, VP>(Vs, v + base + size_t(k0) * D, 1.f);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RM], b[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) b[j] = Ks[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    if (causal && k0 + BK - 1 > q0) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j)
          if (k0 + tx + 16 * j > q0 + ty + 16 * i) s[i][j] = kNegInf;
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < CN; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < CN; ++j) Ps[(ty + 16 * i) * PP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float a[RM], b[CD];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = Ps[(ty + 16 * i) * PP + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) b[c] = Vs[j * VP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    T* out = o + base + size_t(row) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) store(out + tx + 16 * c, acc[i][c] / l[i]);
    if (tx == 0) lse[size_t(blockIdx.y) * S + row] = m[i] + logf(l[i]);
  }
}

// ---- B2b: dQ ----------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq,
                int S, float scale, int causal) {
  constexpr int BQ = Tiles<D>::Q, BK = Tiles<D>::K;
  constexpr int P = D + 1, SP = BK + 1;
  constexpr int RM = BQ / 16, CN = BK / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * P;
  float* Ks = dOs + BQ * P;
  float* Vs = Ks + BK * P;
  float* dSs = Vs + BK * P;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int q0 = qi * BQ;
  const size_t base = size_t(blockIdx.y) * S * D;
  const size_t row_base = size_t(blockIdx.y) * S;

  load_tile<T, BQ, D, P>(Qs, q + base + size_t(q0) * D, 1.f);
  load_tile<T, BQ, D, P>(dOs, dout + base + size_t(q0) * D, 1.f);

  float lse_r[RM], delta_r[RM], acc[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    lse_r[i] = lse[row_base + q0 + ty + 16 * i];
    delta_r[i] = delta[row_base + q0 + ty + 16 * i];
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = causal ? (q0 + BQ + BK - 1) / BK : S / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<T, BK, D, P>(Ks, k + base + size_t(k0) * D, 1.f);
    load_tile<T, BK, D, P>(Vs, v + base + size_t(k0) * D, 1.f);
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RM], g[RM], b[CN], w[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        a[i] = Qs[(ty + 16 * i) * P + d];
        g[i] = dOs[(ty + 16 * i) * P + d];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        b[j] = Ks[(tx + 16 * j) * P + d];
        w[j] = Vs[(tx + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }
    const bool diag = causal && k0 + BK - 1 > q0;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        float x = s[i][j] * scale;
        if (diag && k0 + tx + 16 * j > q0 + ty + 16 * i) x = kNegInf;
        const float p = expf(x - lse_r[i]);
        dSs[(ty + 16 * i) * SP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float a[RM], b[CD];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = dSs[(ty + 16 * i) * SP + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) b[c] = Ks[j * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    T* out = dq + base + size_t(q0 + ty + 16 * i) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) store(out + tx + 16 * c, acc[i][c] * scale);
  }
}

// ---- B2c: dK / dV -----------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int S, float scale, int causal) {
  constexpr int BQ = Tiles<D>::Q, BK = Tiles<D>::K;
  constexpr int P = D + 1, TP = BQ + 1;
  constexpr int RK = BK / 16, CQ = BQ / 16, CD = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * P;
  float* Qs = Vs + BK * P;
  float* dOs = Qs + BQ * P;
  float* Pt = dOs + BQ * P;   // p^T  [BK, BQ]
  float* dSt = Pt + BK * TP;  // ds^T [BK, BQ]
  float* lse_s = dSt + BK * TP;
  float* delta_s = lse_s + BQ;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * BK;  // early kv-tiles see the most q-tiles
  const size_t base = size_t(blockIdx.y) * S * D;
  const size_t row_base = size_t(blockIdx.y) * S;

  load_tile<T, BK, D, P>(Ks, k + base + size_t(k0) * D, 1.f);
  load_tile<T, BK, D, P>(Vs, v + base + size_t(k0) * D, 1.f);

  float dk_acc[RK][CD], dv_acc[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: the first q-tile whose last row reaches k0 (the TPU's `live`)
  const int first = causal ? k0 / BQ : 0;
  for (int qt = first; qt < S / BQ; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous q-tile's readers are done
    load_tile<T, BQ, D, P>(Qs, q + base + size_t(q0) * D, 1.f);
    load_tile<T, BQ, D, P>(dOs, dout + base + size_t(q0) * D, 1.f);
    if (threadIdx.x < BQ) {
      lse_s[threadIdx.x] = lse[row_base + q0 + threadIdx.x];
      delta_s[threadIdx.x] = delta[row_base + q0 + threadIdx.x];
    }
    __syncthreads();

    // transposed scores: rows are keys ty + 16*i, columns queries tx + 16*j
    float s[RK][CQ], dp[RK][CQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < CQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RK], w[RK], b[CQ], g[CQ];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        a[i] = Ks[(ty + 16 * i) * P + d];
        w[i] = Vs[(ty + 16 * i) * P + d];
      }
#pragma unroll
      for (int j = 0; j < CQ; ++j) {
        b[j] = Qs[(tx + 16 * j) * P + d];
        g[j] = dOs[(tx + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(w[i], g[j], dp[i][j]);
        }
    }
    const bool diag = causal && q0 < k0 + BK - 1;
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < CQ; ++j) {
        const int qc = tx + 16 * j;
        float x = s[i][j] * scale;
        if (diag && q0 + qc < k0 + ty + 16 * i) x = kNegInf;
        const float p = expf(x - lse_s[qc]);
        Pt[(ty + 16 * i) * TP + qc] = p;
        dSt[(ty + 16 * i) * TP + qc] = p * (dp[i][j] - delta_s[qc]);
      }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BQ; ++j) {
      float pa[RK], da[RK], ob[CD], qb[CD];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        pa[i] = Pt[(ty + 16 * i) * TP + j];
        da[i] = dSt[(ty + 16 * i) * TP + j];
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        ob[c] = dOs[j * P + tx + 16 * c];
        qb[c] = Qs[j * P + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dv_acc[i][c] = fmaf(pa[i], ob[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(da[i], qb[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const size_t row = base + size_t(k0 + ty + 16 * i) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      store(dk + row + tx + 16 * c, dk_acc[i][c] * scale);
      store(dv + row + tx + 16 * c, dv_acc[i][c]);
    }
  }
}

// ---- bf16 on the tensor cores: fragments, copies ----------------------------

typedef __nv_bfloat16 bf16;

constexpr int kMmaThreads = 128;  // 4 warps, 16 rows each
constexpr int kMmaRows = 64;      // rows a block owns (queries or keys)
constexpr int kPad = 8;           // bf16 of padding after each smem row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i of lane l holds its row l/4, columns 2(l%4)
// and 2(l%4)+1 (.trans: rows 2(l%4), 2(l%4)+1 of column l/4)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, fp32 accumulators.
// Lane l (g = l/4, t = l%4) holds c rows g (c[0], c[1]) and g+8 (c[2],
// c[3]) at columns 2t, 2t+1; a rows g (a[0]) and g+8 (a[1]) at columns
// 2t, 2t+1, and the same rows at columns 2t+8, 2t+9 (a[2], a[3]); b rows
// 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1) of column g. A 32-bit register holds
// two bf16, the lower column (or row, for b) in its low half.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) as bf16 hi = bf16(x) and lo = bf16(x - hi); x - hi is exact
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// the A fragments (hi, lo) of a 16 x 16 tile held as two m16n8
// accumulator tiles c0 (columns 0-7) and c1 (columns 8-15)
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

// The ldmatrix address of lane `lane` for the three operand patterns, in
// a smem tile of row pitch P:
// the A fragment of the 16 x 16 block at (r0, c0) of a row-major tile
__device__ __forceinline__ const bf16* a_at(const bf16* tile, int P, int r0,
                                            int c0, int lane) {
  return tile + (r0 + (lane & 15)) * P + c0 + (lane >> 4) * 8;
}
// the B fragments of two n8 tiles (n0, n0 + 8) over k0..k0+15 of a tile
// stored [n][k], for ldsm_x4: registers 0, 1 are tile n0's b0, b1 and
// registers 2, 3 tile n0 + 8's
__device__ __forceinline__ const bf16* bt_at(const bf16* tile, int P,
                                             int n0, int k0, int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * P + k0 +
         ((lane >> 3) & 1) * 8;
}
// the same fragments of a tile stored [k][n], for ldsm_x4_t
__device__ __forceinline__ const bf16* b_at(const bf16* tile, int P, int k0,
                                            int n0, int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + n0 +
         (lane >> 4) * 8;
}

// ROWS x D contiguous bf16 from global src into a smem tile of pitch
// D + kPad, in 16-byte cp.async chunks spread over the block
template <int ROWS, int D>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src) {
  constexpr int kPerRow = D / 8;
  constexpr int kChunks = ROWS * kPerRow;
  static_assert(kChunks % kMmaThreads == 0, "tile does not split evenly");
#pragma unroll
  for (int i = 0; i < kChunks / kMmaThreads; ++i) {
    const int c = threadIdx.x + i * kMmaThreads;
    const int r = c / kPerRow, col = (c % kPerRow) * 8;
    cp_async16(dst + r * (D + kPad) + col, src + size_t(r) * D + col);
  }
}

// max / sum over the quad (the 4 lanes that share a fragment row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- B2a, bf16: forward on the tensor cores ---------------------------------

template <int D> struct FwdMma {
  static constexpr int BQ = kMmaRows;
  static constexpr int BK = D == 256 ? 32 : 64;
  static constexpr bool kQInRegs = D <= 128;
  static constexpr size_t smem_bytes() {
    return (size_t(BQ) + 4 * BK) * (D + kPad) * sizeof(bf16);
  }
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, float scale,
                     int causal) {
  using T = FwdMma<D>;
  constexpr int BQ = T::BQ, BK = T::BK, P = D + kPad;
  constexpr int KD = D / 16;  // k16 steps of q k^T
  constexpr int NK = BK / 8;  // n8 tiles of a score row
  constexpr int ND = D / 8;   // n8 tiles of an output row
  constexpr int QR = T::kQInRegs ? KD : 1;
  extern __shared__ uint4 mma_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(mma_smem);
  bf16* Ks = Qs + BQ * P;      // [2][BK][P]
  bf16* Vs = Ks + 2 * BK * P;  // [2][BK][P]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int wr = warp * 16;                          // the warp's rows
  const size_t base = size_t(blockIdx.y) * S * D;
  const int n_tiles = causal ? (q0 + BQ + BK - 1) / BK : S / BK;

  cp_tile<BQ, D>(Qs, q + base + size_t(q0) * D);
  cp_tile<BK, D>(Ks, k + base);
  cp_tile<BK, D>(Vs, v + base);
  cp_async_commit();

  uint32_t qf[QR][4];
  float acc[ND][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, k0 = it * BK;
    if (it + 1 < n_tiles) {  // the next tile, in flight while this one runs
      const size_t next = base + size_t(k0 + BK) * D;
      cp_tile<BK, D>(Ks + (stage ^ 1) * BK * P, k + next);
      cp_tile<BK, D>(Vs + (stage ^ 1) * BK * P, v + next);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + stage * BK * P;
    const bf16* Vt = Vs + stage * BK * P;
    if (T::kQInRegs && it == 0) {
#pragma unroll
      for (int kk = 0; kk < QR; ++kk)
        ldsm_x4(qf[kk], a_at(Qs, P, wr, kk * 16, lane));
    }

    // s = q k^T for the warp's 16 rows and the tile's BK keys
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if (T::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk % QR][e];
      } else {
        ldsm_x4(a, a_at(Qs, P, wr, kk * 16, lane));
      }
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        uint32_t b[4];
        ldsm_x4(b, bt_at(Kt, P, n * 8, kk * 16, lane));
        mma(s[n], a, b[0], b[1]);
        mma(s[n + 1], a, b[2], b[3]);
      }
    }

    // scale, mask, online softmax (rows g and g + 8 of the warp)
    const bool diag = causal && k0 + BK - 1 > q0 + wr;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (diag &&
            k0 + n * 8 + 2 * t + (e & 1) > q0 + wr + g + (e >> 1) * 8)
          x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // O += P v, P split into hi + lo, 16 keys at a time
#pragma unroll
    for (int j = 0; j < NK / 2; ++j) {
      uint32_t ph[4], pl[4];
      split_a(s[2 * j], s[2 * j + 1], ph, pl);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, b_at(Vt, P, j * 16, n * 8, lane));
        mma(acc[n], ph, b[0], b[1]);
        mma(acc[n], pl, b[0], b[1]);
        mma(acc[n + 1], ph, b[2], b[3]);
        mma(acc[n + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    const int row = q0 + wr + g + r * 8;
    bf16* out = o + base + size_t(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] / l[r],
                                acc[n][2 * r + 1] / l[r]);
    if (t == 0) lse[size_t(blockIdx.y) * S + row] = m[r] + logf(l[r]);
  }
}

// ---- B2b, bf16: dQ on the tensor cores --------------------------------------

template <int D> struct DqMma {
  static constexpr int BQ = kMmaRows;
  static constexpr int BK = D == 256 ? 32 : 64;
  static constexpr bool kQInRegs = D <= 128;
  static constexpr bool kDOInRegs = D <= 64;
  static constexpr size_t smem_bytes() {
    return (2 * size_t(BQ) + 4 * BK) * (D + kPad) * sizeof(bf16);
  }
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int S, float scale, int causal) {
  using T = DqMma<D>;
  constexpr int BQ = T::BQ, BK = T::BK, P = D + kPad;
  constexpr int KD = D / 16;  // k16 steps of q k^T and dO v^T
  constexpr int NK = BK / 8;  // n8 tiles of a score row
  constexpr int ND = D / 8;   // n8 tiles of a dQ row
  constexpr int QR = T::kQInRegs ? KD : 1;
  constexpr int GR = T::kDOInRegs ? KD : 1;
  extern __shared__ uint4 mma_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(mma_smem);
  bf16* dOs = Qs + BQ * P;
  bf16* Ks = dOs + BQ * P;     // [2][BK][P]
  bf16* Vs = Ks + 2 * BK * P;  // [2][BK][P]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int wr = warp * 16;                          // the warp's rows
  const size_t base = size_t(blockIdx.y) * S * D;
  const size_t row_base = size_t(blockIdx.y) * S + q0 + wr + g;
  const int n_tiles = causal ? (q0 + BQ + BK - 1) / BK : S / BK;

  cp_tile<BQ, D>(Qs, q + base + size_t(q0) * D);
  cp_tile<BQ, D>(dOs, dout + base + size_t(q0) * D);
  cp_tile<BK, D>(Ks, k + base);
  cp_tile<BK, D>(Vs, v + base);
  cp_async_commit();

  // LSE and delta of the warp's rows g and g + 8
  const float lse_r[2] = {lse[row_base], lse[row_base + 8]};
  const float delta_r[2] = {delta[row_base], delta[row_base + 8]};
  uint32_t qf[QR][4], gf[GR][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, k0 = it * BK;
    if (it + 1 < n_tiles) {  // the next tile, in flight while this one runs
      const size_t next = base + size_t(k0 + BK) * D;
      cp_tile<BK, D>(Ks + (stage ^ 1) * BK * P, k + next);
      cp_tile<BK, D>(Vs + (stage ^ 1) * BK * P, v + next);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + stage * BK * P;
    const bf16* Vt = Vs + stage * BK * P;
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < QR; ++kk)
        if (T::kQInRegs) ldsm_x4(qf[kk], a_at(Qs, P, wr, kk * 16, lane));
#pragma unroll
      for (int kk = 0; kk < GR; ++kk)
        if (T::kDOInRegs) ldsm_x4(gf[kk], a_at(dOs, P, wr, kk * 16, lane));
    }

    // s = q k^T and dp = dO v^T for the warp's 16 rows and BK keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4], ag[4];
      if (T::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) aq[e] = qf[kk % QR][e];
      } else {
        ldsm_x4(aq, a_at(Qs, P, wr, kk * 16, lane));
      }
      if (T::kDOInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ag[e] = gf[kk % GR][e];
      } else {
        ldsm_x4(ag, a_at(dOs, P, wr, kk * 16, lane));
      }
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        uint32_t b[4];
        ldsm_x4(b, bt_at(Kt, P, n * 8, kk * 16, lane));
        mma(s[n], aq, b[0], b[1]);
        mma(s[n + 1], aq, b[2], b[3]);
        ldsm_x4(b, bt_at(Vt, P, n * 8, kk * 16, lane));
        mma(dp[n], ag, b[0], b[1]);
        mma(dp[n + 1], ag, b[2], b[3]);
      }
    }

    // p = exp(scale s - LSE), ds = p (dp - delta), masked in the fragment
    // layout on the diagonal tile (rows g and g + 8 of the warp)
    const bool diag = causal && k0 + BK - 1 > q0 + wr;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (diag &&
            k0 + n * 8 + 2 * t + (e & 1) > q0 + wr + g + (e >> 1) * 8)
          x = kNegInf;
        const float p = expf(x - lse_r[e >> 1]);
        dp[n][e] = p * (dp[n][e] - delta_r[e >> 1]);
      }

    // dQ += ds k, ds split into hi + lo, 16 keys at a time
#pragma unroll
    for (int j = 0; j < NK / 2; ++j) {
      uint32_t dh[4], dl[4];
      split_a(dp[2 * j], dp[2 * j + 1], dh, dl);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, b_at(Kt, P, j * 16, n * 8, lane));
        mma(acc[n], dh, b[0], b[1]);
        mma(acc[n], dl, b[0], b[1]);
        mma(acc[n + 1], dh, b[2], b[3]);
        mma(acc[n + 1], dl, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* out = dq + base + size_t(q0 + wr + g + r * 8) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] * scale,
                                acc[n][2 * r + 1] * scale);
  }
}

// ---- B2c, bf16: dK / dV on the tensor cores ---------------------------------

template <int D> struct DkvMma {
  static constexpr int BK = kMmaRows;
  static constexpr int BQ = D == 256 ? 32 : 64;
  static constexpr int DO = D == 256 ? 128 : D;  // output columns a block
  static constexpr bool kKVInRegs = D == 64;
  static constexpr size_t smem_bytes() {
    return (2 * size_t(BK) + 4 * BQ) * (D + kPad) * sizeof(bf16) +
           4 * size_t(BQ) * sizeof(float);
  }
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, float scale, int causal) {
  using T = DkvMma<D>;
  constexpr int BK = T::BK, BQ = T::BQ, DO = T::DO, P = D + kPad;
  constexpr int KD = D / 16;  // k16 steps of k q^T
  constexpr int NO = DO / 8;  // n8 tiles of the block's output columns
  constexpr int KR = T::kKVInRegs ? KD : 1;
  extern __shared__ uint4 mma_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(mma_smem);
  bf16* Vs = Ks + BK * P;
  bf16* Qs = Vs + BK * P;       // [2][BQ][P]
  bf16* dOs = Qs + 2 * BQ * P;  // [2][BQ][P]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BQ * P);  // [2][BQ]
  float* Ds = Ls + 2 * BQ;                                  // [2][BQ]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BK;  // early kv-tiles see the most q-tiles
  const int c0 = blockIdx.z * DO;  // the block's output columns
  const int wr = warp * 16;        // the warp's key rows
  const size_t base = size_t(blockIdx.y) * S * D;
  const size_t row_base = size_t(blockIdx.y) * S;
  // causal: the first q-tile whose last row reaches k0 (the TPU's `live`)
  const int first = causal ? k0 / BQ : 0, n_q = S / BQ;

  // q-tile qt's Q, dO, LSE and delta into ring stage `stage`
  auto load_q_tile = [&](int qt, int stage) {
    const size_t at = base + size_t(qt) * BQ * D;
    cp_tile<BQ, D>(Qs + stage * BQ * P, q + at);
    cp_tile<BQ, D>(dOs + stage * BQ * P, dout + at);
    const int i = threadIdx.x;  // BQ / 4 chunks of each row vector
    const size_t rows = row_base + size_t(qt) * BQ;
    if (i < BQ / 4)
      cp_async16(Ls + stage * BQ + 4 * i, lse + rows + 4 * i);
    else if (i < BQ / 2)
      cp_async16(Ds + stage * BQ + 4 * (i - BQ / 4),
                 delta + rows + 4 * (i - BQ / 4));
  };
  cp_tile<BK, D>(Ks, k + base + size_t(k0) * D);
  cp_tile<BK, D>(Vs, v + base + size_t(k0) * D);
  load_q_tile(first, 0);
  cp_async_commit();

  uint32_t kf[KR][4], vf[KR][4];
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int qt = first; qt < n_q; ++qt) {
    const int stage = (qt - first) & 1, q0 = qt * BQ;
    if (qt + 1 < n_q) {
      load_q_tile(qt + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (T::kKVInRegs && qt == first) {
#pragma unroll
      for (int kk = 0; kk < KR; ++kk) {
        ldsm_x4(kf[kk], a_at(Ks, P, wr, kk * 16, lane));
        ldsm_x4(vf[kk], a_at(Vs, P, wr, kk * 16, lane));
      }
    }
    const bf16* Qt = Qs + stage * BQ * P;
    const bf16* dOt = dOs + stage * BQ * P;
    const float* Lt = Ls + stage * BQ;
    const float* Dt = Ds + stage * BQ;
    const bool diag = causal && q0 < k0 + wr + 15;

#pragma unroll 1
    for (int qs = 0; qs < BQ / 16; ++qs) {
      // 16 queries wholly before the warp's keys: p = 0, no contribution
      if (causal && q0 + qs * 16 + 15 < k0 + wr) continue;
      // s^T = k q^T and dp^T = v dO^T: 16 keys x 16 queries
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ak[4], av[4], b[4];
        if (T::kKVInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ak[e] = kf[kk % KR][e];
            av[e] = vf[kk % KR][e];
          }
        } else {
          ldsm_x4(ak, a_at(Ks, P, wr, kk * 16, lane));
          ldsm_x4(av, a_at(Vs, P, wr, kk * 16, lane));
        }
        ldsm_x4(b, bt_at(Qt, P, qs * 16, kk * 16, lane));
        mma(st[0], ak, b[0], b[1]);
        mma(st[1], ak, b[2], b[3]);
        ldsm_x4(b, bt_at(dOt, P, qs * 16, kk * 16, lane));
        mma(dpt[0], av, b[0], b[1]);
        mma(dpt[1], av, b[2], b[3]);
      }
      // p^T = exp(scale s^T - LSE), ds^T = p^T (dp^T - delta), by column
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = qs * 16 + n * 8 + 2 * t + (e & 1);
          float x = st[n][e] * scale;
          if (diag && q0 + qc < k0 + wr + g + (e >> 1) * 8) x = kNegInf;
          const float p = expf(x - Lt[qc]);
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - Dt[qc]);
        }
      uint32_t ph[4], pl[4], dh[4], dl[4];
      split_a(st[0], st[1], ph, pl);
      split_a(dpt[0], dpt[1], dh, dl);
      // dV += p^T dO, dK += ds^T q over the block's output columns
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, b_at(dOt, P, qs * 16, c0 + n * 8, lane));
        mma(dva[n], ph, b[0], b[1]);
        mma(dva[n], pl, b[0], b[1]);
        mma(dva[n + 1], ph, b[2], b[3]);
        mma(dva[n + 1], pl, b[2], b[3]);
        ldsm_x4_t(b, b_at(Qt, P, qs * 16, c0 + n * 8, lane));
        mma(dka[n], dh, b[0], b[1]);
        mma(dka[n], dl, b[0], b[1]);
        mma(dka[n + 1], dh, b[2], b[3]);
        mma(dka[n + 1], dl, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = base + size_t(k0 + wr + g + r * 8) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + row + n * 8) =
          __floats2bfloat162_rn(dka[n][2 * r] * scale,
                                dka[n][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + n * 8) =
          __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// ---- launchers ----------------------------------------------------------------

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int S, float scale, int causal,
                cudaStream_t stream) {
  if (S % Tiles<D>::Q || S % Tiles<D>::K) return cudaErrorInvalidValue;
  const size_t smem = fwd_smem_floats<D>() * sizeof(float);
  cudaError_t err = prepare(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / Tiles<D>::Q, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dq(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* dq_out, int bh, int S, float scale, int causal,
               cudaStream_t stream) {
  if (S % Tiles<D>::Q || S % Tiles<D>::K) return cudaErrorInvalidValue;
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = prepare(flash_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / Tiles<D>::Q, bh);
  flash_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq_out), S, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dkv(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, int bh, int S, float scale, int causal,
                cudaStream_t stream) {
  if (S % Tiles<D>::Q || S % Tiles<D>::K) return cudaErrorInvalidValue;
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = prepare(flash_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / Tiles<D>::K, bh);
  flash_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_mma(const void* q, const void* k, const void* v, void* o,
                    float* lse, int bh, int S, float scale, int causal,
                    cudaStream_t stream) {
  using T = FwdMma<D>;
  if (S % T::BQ || S % T::BK) return cudaErrorInvalidValue;
  const size_t smem = T::smem_bytes();
  cudaError_t err = prepare(flash_fwd_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / T::BQ, bh);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S, scale,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_mma(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq_out, int bh, int S, float scale, int causal,
                   cudaStream_t stream) {
  using T = DqMma<D>;
  if (S % T::BQ || S % T::BK) return cudaErrorInvalidValue;
  const size_t smem = T::smem_bytes();
  cudaError_t err = prepare(flash_dq_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / T::BQ, bh);
  flash_dq_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dq_out), S, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_mma(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int bh, int S, float scale,
                    int causal, cudaStream_t stream) {
  using T = DkvMma<D>;
  if (S % T::BQ || S % T::BK) return cudaErrorInvalidValue;
  const size_t smem = T::smem_bytes();
  cudaError_t err = prepare(flash_dkv_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / T::BK, bh, D / T::DO);
  flash_dkv_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, scale,
      causal);
  return cudaGetLastError();
}

// CALL with D bound to the head dim d, one of {64, 128, 256}; any other
// d is refused
#define BY_HEAD_DIM(CALL)                              \
  switch (d) {                                         \
    case 64: { constexpr int D = 64; return CALL; }    \
    case 128: { constexpr int D = 128; return CALL; }  \
    case 256: { constexpr int D = 256; return CALL; }  \
    default: return cudaErrorInvalidValue;             \
  }

}  // namespace

// dtype: 0 = fp32 (SIMT), 1 = bf16 (tensor cores); any other type is
// refused

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int bh, int s, int d, int dtype,
                                   float scale, int causal, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    BY_HEAD_DIM((fwd<float, D>(q, k, v, o, lse, bh, s, scale, causal, st)));
  if (dtype == 1)
    BY_HEAD_DIM((fwd_mma<D>(q, k, v, o, lse, bh, s, scale, causal, st)));
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dq_out, int bh, int s, int d,
                                  int dtype, float scale, int causal,
                                  void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    BY_HEAD_DIM((dq<float, D>(q, k, v, dout, lse, delta, dq_out, bh, s,
                              scale, causal, st)));
  if (dtype == 1)
    BY_HEAD_DIM((dq_mma<D>(q, k, v, dout, lse, delta, dq_out, bh, s,
                           scale, causal, st)));
  return cudaErrorInvalidValue;
}

extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, int bh, int s, int d,
                                   int dtype, float scale, int causal,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    BY_HEAD_DIM((dkv<float, D>(q, k, v, dout, lse, delta, dk, dv, bh, s,
                               scale, causal, st)));
  if (dtype == 1)
    BY_HEAD_DIM((dkv_mma<D>(q, k, v, dout, lse, delta, dk, dv, bh, s,
                            scale, causal, st)));
  return cudaErrorInvalidValue;
}
