// Flash attention for Hopper (sm_90a): the forward, the dQ pass and the
// dK/dV pass, on [B*H, S, D] row-major tensors of fp32 or bf16, with fp32
// arithmetic inside.
//
// Replaces the three Pallas TPU kernels of
// paddle_operator_tpu/ops/attention_pallas.py:
//   flash_fwd_kernel  <- _fwd_kernel  (launched by _flash_fwd)
//   flash_dq_kernel   <- _dq_kernel   (launched by _flash_bwd)
//   flash_dkv_kernel  <- _dkv_kernel  (launched by _flash_bwd)
//
// What they compute, per (batch*head) and with NEG_INF = -1e30 above the
// diagonal when causal:
//   fwd: s = (q*scale) k^T; O = softmax(s) v; LSE = m + log(l), by an
//        online softmax over K/V tiles (running max m, denominator l);
//   dq:  p = exp(scale * q k^T - LSE); ds = p * (dO v^T - delta);
//        dQ = scale * ds k;
//   dkv: dV = p^T dO; dK = scale * ds^T q.
// delta = rowsum(dO * O) (minus the LSE cotangent) is computed outside, as
// in the JAX package. The scaling order is the TPU kernels': the forward
// scales q before the product, the backward passes scale the product.
//
// Bound: at the training shape (S = 1024, D = 64, bf16) each kernel does
// 2-4 products of 2*S*S*D/2 flops per head against 4-6 tensors of S*D
// bf16 elements (plus LSE and delta), about 250-340 flops per byte: at the
// card's bf16 balance point (about 295), so the least time is the larger
// of the bf16 tensor-core time and the HBM time, within 20 % of each
// other. This design runs on fp32 CUDA cores (67 TFLOP/s
// at best) and is bound by its own instruction issue, far above that
// bound; tensor-core tiles (mma/wgmma) are later work.
//
// Design (simple and right first):
//  * 256 threads as a 16 x 16 grid (ty, tx). A score tile [R, C] is held
//    in registers, thread (ty, tx) owning rows ty + 16*i and columns
//    tx + 16*j; an output tile [R, D] likewise owns rows ty + 16*i and
//    columns tx + 16*j. The 16 threads of a row are 16 lanes of one warp,
//    so row max and row sum are warp shuffles, and a row's softmax state
//    (m, l, the correction) lives in the registers that own its outputs.
//  * Tiles are staged from global memory through shared memory as fp32
//    (bf16 converted at load), row pitch D + 1 where a warp reads down a
//    column (no bank conflicts). A tile of R rows is R*D contiguous
//    elements, so loads are coalesced 4-element vectors.
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
//  * Tiles: 64 x 64 for D in {64, 128}, 32 x 32 for D = 256, so that every
//    kernel's shared memory fits in one SM (at most 166 KB, set with
//    cudaFuncAttributeMaxDynamicSharedMemorySize). S must be a multiple of
//    the tile; the Python wrapper checks S % 128 == 0 and D.
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

// ---- loads and stores of the two input types ------------------------------

__device__ __forceinline__ void load4(const float* p, float* out) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
  __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
  float2 a = __bfloat1622float2(lo);
  float2 b = __bfloat1622float2(hi);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as a torch cast
}

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

// dtype: 0 = fp32, 1 = bf16; D in {64, 128, 256}; anything else is refused
#define FLASH_DISPATCH(FN, ...)                                   \
  if (dtype == 0 && d == 64) return FN<float, 64>(__VA_ARGS__);   \
  if (dtype == 0 && d == 128) return FN<float, 128>(__VA_ARGS__); \
  if (dtype == 0 && d == 256) return FN<float, 256>(__VA_ARGS__); \
  if (dtype == 1 && d == 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__);   \
  if (dtype == 1 && d == 128) return FN<__nv_bfloat16, 128>(__VA_ARGS__); \
  if (dtype == 1 && d == 256) return FN<__nv_bfloat16, 256>(__VA_ARGS__); \
  return cudaErrorInvalidValue

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int bh, int s, int d, int dtype,
                                   float scale, int causal, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(fwd, q, k, v, o, lse, bh, s, scale, causal, st);
}

extern "C" int flash_attention_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dq_out, int bh, int s, int d,
                                  int dtype, float scale, int causal,
                                  void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, dq_out, bh, s, scale,
                 causal, st);
}

extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, int bh, int s, int d,
                                   int dtype, float scale, int causal,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dkv, q, k, v, dout, lse, delta, dk, dv, bh, s, scale,
                 causal, st);
}
