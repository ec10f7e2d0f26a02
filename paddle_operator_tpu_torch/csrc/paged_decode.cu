// Single-token decode attention over a paged KV cache, fp32, for Hopper
// (sm_90a).
//
// Replaces paddle_operator_tpu/ops/attention_pallas.py::_paged_decode_kernel
// (the Pallas TPU kernel behind paged_decode_attention).
//
// What it computes: for every sequence b and head h,
//   out[b,h,:] = softmax(scale * q[b,h,:] . K[b,t,h,:], t < lens[b]) @ V[b,:,h,:]
// where K/V row t of sequence b lives in page tables[b, t / bs], slot t % bs
// of the pools k_pages / v_pages, each [P, bs, H, D]. Accumulation is fp32.
//
// Bound: memory. Each live token costs 2*D*4 bytes of K/V per head and one
// multiply-add per element, about 0.25 flop per byte; the least time is the
// live K/V bytes (plus q and out) over the card's HBM rate.
//
// Design (a simple kernel that is right; split-K, cp.async/TMA and bf16
// pages are later work):
//  * one thread block per (head, sequence), grid (H, B). The block reads its
//    own block-table entries (the TPU kernel got them by scalar prefetch)
//    and walks only the ceil(len / bs) pages it needs; the TPU grid visits
//    all T pages and masks the dead ones, which gives the same result;
//  * WARPS warps split the live tokens in chunks of U consecutive tokens,
//    interleaved across warps. A lane holds D/32 contiguous elements of q,
//    so one token's K row is one coalesced warp load; U tokens are loaded
//    before any is used, so each warp keeps 2*U loads in flight;
//  * q.k is a warp-shuffle reduction; each warp keeps its own online
//    softmax (running max m, denominator l, context acc in registers);
//  * the warps' partial states are merged once through shared memory and
//    the context row is written once. The TPU's 128-lane replication of
//    m and l (MIN_BLOCK) is a TPU layout rule and is dropped.
//
// Contract: lens[b] >= 1 (a sequence with 0 live tokens gets a zero row);
// lens[b] above T * bs is clamped to T * bs, as the reference's mask does;
// every table entry a live token reaches is a valid page id.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;  // ops/attention.py NEG_INF
constexpr int kWarps = 8;
constexpr int kUnroll = 4;

template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&out)[V]) {
  if constexpr (V == 2) {
    float2 a = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = a.x; out[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      float4 a = __ldg(reinterpret_cast<const float4*>(p + i));
      out[i] = a.x; out[i + 1] = a.y; out[i + 2] = a.z; out[i + 3] = a.w;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pages,
                    const float* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens,
                    float* __restrict__ out,
                    int H, int bs, int T, float scale) {
  constexpr int V = D / 32;  // elements of the head dim per lane
  __shared__ float m_s[kWarps];
  __shared__ float l_s[kWarps];
  __shared__ float acc_s[kWarps][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row = (static_cast<size_t>(b) * H + h) * D;
  const int len = min(lens[b], T * bs);

  if (len <= 0) {
    for (int d = threadIdx.x; d < D; d += blockDim.x) out[row + d] = 0.f;
    return;
  }

  float qv[V];
  load_vec<V>(q + row + lane * V, qv);
#pragma unroll
  for (int i = 0; i < V; ++i) qv[i] *= scale;

  const int* table = tables + static_cast<size_t>(b) * T;
  const size_t slot_stride = static_cast<size_t>(H) * D;
  const size_t page_stride = static_cast<size_t>(bs) * slot_stride;
  const size_t head_off = static_cast<size_t>(h) * D + lane * V;

  float m = kNegInf, l = 0.f;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;

  for (int t0 = warp * kUnroll; t0 < len; t0 += kWarps * kUnroll) {
    float kv[kUnroll][V], vv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < len) {
        const int page = __ldg(table + t / bs);
        const size_t off = static_cast<size_t>(page) * page_stride
                           + static_cast<size_t>(t % bs) * slot_stride
                           + head_off;
        load_vec<V>(k_pages + off, kv[u]);
        load_vec<V>(v_pages + off, vv[u]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) kv[u][i] = vv[u][i] = 0.f;
      }
    }
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) s[u] = fmaf(qv[i], kv[u][i], s[u]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (t0 + u < len) m_new = fmaxf(m_new, s[u]);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = (t0 + u < len) ? expf(s[u] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = fmaf(p, vv[u][i], acc[i]);
    }
    m = m_new;
  }

  // merge the warps' online-softmax states; a warp that saw no token holds
  // m = kNegInf, l = 0, acc = 0 and weighs exp(kNegInf - M) = 0
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) acc_s[warp][lane * V + i] = acc[i];
  __syncthreads();

  float m_all = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_s[w]);
  float weight[kWarps];
  float l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    weight[w] = expf(m_s[w] - m_all);
    l_all += l_s[w] * weight[w];
  }
  const float inv_l = 1.f / l_all;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o = fmaf(acc_s[w][d], weight[w], o);
    out[row + d] = o * inv_l;
  }
}

template <int D>
void launch(const float* q, const float* k_pages, const float* v_pages,
            const int* tables, const int* lens, float* out, int B, int H,
            int bs, int T, float scale, cudaStream_t stream) {
  dim3 grid(H, B);
  paged_decode_kernel<D><<<grid, kWarps * 32, 0, stream>>>(
      q, k_pages, v_pages, tables, lens, out, H, bs, T, scale);
}

}  // namespace

// q, out [B,H,D] fp32; k_pages, v_pages [P,bs,H,D] fp32; tables [B,T] int32;
// lens [B] int32; all contiguous on the current device. Returns the CUDA
// error of the launch (0 = cudaSuccess).
extern "C" int paged_decode_f32(const void* q, const void* k_pages,
                                const void* v_pages, const void* tables,
                                const void* lens, void* out, int B, int H,
                                int D, int bs, int T, float scale,
                                void* stream) {
  if (B == 0 || H == 0) return static_cast<int>(cudaSuccess);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k_pages);
  const auto* vf = static_cast<const float*>(v_pages);
  const auto* tb = static_cast<const int*>(tables);
  const auto* ln = static_cast<const int*>(lens);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: launch<64>(qf, kf, vf, tb, ln, of, B, H, bs, T, scale, st); break;
    case 128: launch<128>(qf, kf, vf, tb, ln, of, B, H, bs, T, scale, st); break;
    case 256: launch<256>(qf, kf, vf, tb, ln, of, B, H, bs, T, scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
