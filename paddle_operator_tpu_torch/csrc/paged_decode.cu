// Single-token decode attention over a paged KV cache, for Hopper (sm_90a),
// split over pages (flash-decoding).
//
// Replaces paddle_operator_tpu/ops/attention_pallas.py::_paged_decode_kernel
// (the Pallas TPU kernel behind paged_decode_attention).
//
// What it computes: for every sequence b and head h, over the T * bs slots
// of the sequence's block table,
//   out[b,h,:] = softmax(s) @ V[b,:,h,:],  s_t = scale * q[b,h,:] . K[b,t,h,:]
// with s_t = NEG_INF = -1e30 for t >= lens[b], where K/V row t lives in page
// tables[b, t / bs], slot t % bs of the pools k_pages / v_pages, each
// [P, bs, H, D]. q is fp32 or bf16, the pools fp32 or bf16, independently;
// every product and sum is fp32 and the output has q's type, as in the
// reference (which casts q and the pages to fp32 inside its kernel).
//
// Contract: NEG_INF is finite, as in the reference. A sequence with
// lens[b] <= 0 therefore scores NEG_INF at every one of its T * bs slots;
// the scores tie and the output is the mean of V over those slots (every
// table entry must then be a valid page id). For lens[b] >= 1 a masked slot
// weighs exp(NEG_INF - max) = 0 exactly and is not read; lens[b] above
// T * bs is clamped to T * bs, as the reference's mask does; every table
// entry a live token reaches is a valid page id.
//
// Bound: memory. Each live token costs 2 * D K/V elements per head (4 or 2
// bytes each) and 2 * D multiply-adds, under 1 flop per byte; the least time
// is the live K/V bytes (plus q, out, tables and lens) over the card's HBM
// rate. The design's job is to keep enough loads in flight to reach it: a
// decode batch is a few sequences, so one block per (head, sequence) leaves
// most SMs idle and a long sequence's block waits on one load after another.
//
// Design:
//  * pass 1, paged_decode_split_kernel, grid (splits, H, B): split j of
//    (b, h) takes pages [j * pps, (j + 1) * pps) of the table. The host
//    chooses pps from bs alone (whole pages, about 128 tokens) and the number
//    of splits from T, never from lens, which would need a device-to-host
//    sync. A block first loads its page ids (into shared memory), the
//    length and q, all at once; a split at or past the sequence's length
//    then writes an empty partial (m = NEG_INF, l = 0, acc = 0).
//  * A block's 4 warps cut the lanes into groups of L lanes, one K/V row to a
//    group, each lane holding E consecutive elements of the row: 16 bytes
//    (one vector load) where the row allows it, so a bf16 row of 64 is 8
//    lanes and a warp reads 4 rows at once. A group takes U consecutive
//    tokens a round and loads all their K and V rows before using any; at
//    D = 64 two rounds cover the split, so a block waits on three loads in
//    a row (page ids, then K/V twice), not one per token. q . k is a shuffle
//    reduction over the group's lanes; each group keeps an online softmax
//    (running max m, denominator l, its part of the context acc) in
//    registers; the groups merge once through shared memory and the block
//    writes its partial state (m, l, acc[D]) in fp32 to scratch the
//    wrapper allocated.
//  * pass 2, paged_decode_merge_kernel, one block of D threads per (b, h):
//    merges the partials in split order and writes the context once, in q's
//    type. It is launched as a programmatic dependent launch: its blocks
//    may be scheduled while pass 1 runs and wait (griddepcontrol.wait) for
//    pass 1's end, which hides most of the gap between two launches.
//  * No atomics, and every sum in a fixed order: two launches on the same
//    inputs give the same bits. The TPU's 128-lane replication of m and l
//    (MIN_BLOCK) is a layout rule of that chip and is dropped.
//
// Every entry point launches on the given stream, allocates and
// synchronises nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape or type it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // ops/attention.py NEG_INF
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSplitTokens = 128;  // ops/attention.py PAGED_SPLIT_TOKENS
constexpr int kMaxSplitPages = kSplitTokens / 8;  // bs is a multiple of 8

// E consecutive elements at p as fp32: 16-byte loads (8-byte ones for four
// bf16); p is aligned to the load's size
template <int E>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&out)[E]) {
  static_assert(E % 4 == 0, "fp32 rows are read 4 elements at a time");
#pragma unroll
  for (int i = 0; i < E; i += 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + i));
    out[i] = a.x; out[i + 1] = a.y; out[i + 2] = a.z; out[i + 3] = a.w;
  }
}

template <int E>
__device__ __forceinline__ void load_row(const bf16* __restrict__ p,
                                         float (&out)[E]) {
  static_assert(E % 4 == 0, "bf16 rows are read 4 or 8 elements at a time");
  if constexpr (E % 8 == 0) {
#pragma unroll
    for (int i = 0; i < E; i += 8) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p + i));
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        out[i + 2 * j] = f.x;
        out[i + 2 * j + 1] = f.y;
      }
    }
  } else {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as a torch cast
}

// How a block's lanes take K/V rows of pool type KT at head dim D: E
// elements a lane, L lanes a row, R rows a warp, G row groups a block, U
// tokens a group has in flight (its K and V rows: 2 * U * E <= 64
// registers; at D = 64 two rounds of the block cover kSplitTokens)
template <typename KT, int D>
struct Rows {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(KT));
  static constexpr int E = kVec > D / 32 ? kVec : D / 32;
  static constexpr int L = D / E;
  static constexpr int R = 32 / L;
  static constexpr int G = kWarps * R;
  static constexpr int U =
      kSplitTokens / G < 32 / E ? kSplitTokens / G : 32 / E;
};

// part: m [n_bhs], l [n_bhs], acc [n_bhs][D], n_bhs = B * H * splits, each
// indexed by (b * H + h) * splits + split
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const QT* __restrict__ q,
                          const KT* __restrict__ k_pages,
                          const KT* __restrict__ v_pages,
                          const int* __restrict__ tables,
                          const int* __restrict__ lens,
                          float* __restrict__ part, int H, int bs, int T,
                          int pps, float scale) {
  using RL = Rows<KT, D>;
  constexpr int E = RL::E, L = RL::L, R = RL::R, G = RL::G, U = RL::U;
  __shared__ int page_s[kMaxSplitPages];
  __shared__ float m_s[G];
  __shared__ float l_s[G];
  __shared__ float acc_s[G][D];

  // the merge kernel may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;");

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t n_bhs = size_t(gridDim.x) * gridDim.y * gridDim.z;
  const size_t at = (size_t(b) * H + h) * gridDim.x + split;
  float* m_out = part + at;
  float* l_out = part + n_bhs + at;
  float* acc_out = part + 2 * n_bhs + at * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp * R + lane / L;  // the lane's row group
  const int col = (lane % L) * E;       // the lane's first element
  const size_t row = (size_t(b) * H + h) * D;

  // the split's page ids, its length and q, all loads in flight at once
  const int p0 = split * pps;
  if (threadIdx.x < pps && p0 + threadIdx.x < T)
    page_s[threadIdx.x] = __ldg(tables + size_t(b) * T + p0 + threadIdx.x);
  const int len = __ldg(lens + b);
  float qv[E];
  load_row<E>(q + row + col, qv);
#pragma unroll
  for (int i = 0; i < E; ++i) qv[i] *= scale;
  __syncthreads();

  const bool empty = len <= 0;  // every slot scores NEG_INF
  const int live = empty ? T * bs : min(len, T * bs);
  const int t_begin = p0 * bs;
  const int t_end = min(t_begin + pps * bs, live);
  if (t_begin >= t_end) {  // past the sequence: an empty partial
    for (int d = threadIdx.x; d < D; d += kThreads) acc_out[d] = 0.f;
    if (threadIdx.x == 0) {
      *m_out = kNegInf;
      *l_out = 0.f;
    }
    return;
  }

  const size_t slot_stride = size_t(H) * D;
  const size_t page_stride = size_t(bs) * slot_stride;
  const size_t head_off = size_t(h) * D + col;

  float m = kNegInf, l = 0.f;
  float acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;

  // a round: the warp's R groups take R * U consecutive tokens (the bound
  // is the same for the whole warp, so the shuffles stay converged)
  for (int base = t_begin + warp * R * U; base < t_end; base += G * U) {
    const int t0 = base + (lane / L) * U;  // the group's first token
    float kv[U][E], vv[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < t_end) {
        const int j = t - t_begin;
        const size_t off = size_t(page_s[j / bs]) * page_stride +
                           size_t(j % bs) * slot_stride + head_off;
        if (!empty) {
          load_row<E>(k_pages + off, kv[u]);
        } else {
#pragma unroll
          for (int i = 0; i < E; ++i) kv[u][i] = 0.f;
        }
        load_row<E>(v_pages + off, vv[u]);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) kv[u][i] = vv[u][i] = 0.f;
      }
    }
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) s[u] = fmaf(qv[i], kv[u][i], s[u]);
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (empty) s[u] = kNegInf;
      if (t0 + u < t_end) m_new = fmaxf(m_new, s[u]);
    }
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < t_end) {
        const float p = expf(s[u] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < E; ++i) acc[i] = fmaf(p, vv[u][i], acc[i]);
      }
    }
    m = m_new;
  }

  // merge the groups' states; a group that saw no token holds m = NEG_INF,
  // l = 0, acc = 0 and adds nothing
  if (lane % L == 0) {
    m_s[grp] = m;
    l_s[grp] = l;
  }
#pragma unroll
  for (int i = 0; i < E; ++i) acc_s[grp][col + i] = acc[i];
  __syncthreads();

  float m_all = kNegInf;
#pragma unroll
  for (int g = 0; g < G; ++g) m_all = fmaxf(m_all, m_s[g]);
  float weight[G];
  float l_all = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    weight[g] = expf(m_s[g] - m_all);
    l_all = fmaf(l_s[g], weight[g], l_all);
  }
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) o = fmaf(acc_s[g][d], weight[g], o);
    acc_out[d] = o;
  }
  if (threadIdx.x == 0) {
    *m_out = m_all;
    *l_out = l_all;
  }
}

// one block of D threads per (b, h): the partials of its splits merged in
// split order, the context written in q's type
template <typename OT, int D>
__global__ void __launch_bounds__(D)
paged_decode_merge_kernel(const float* __restrict__ part,
                          OT* __restrict__ out, int splits) {
  const size_t bh = blockIdx.x;
  const size_t n_bhs = size_t(gridDim.x) * splits;
  const float* m = part + bh * splits;
  const float* l = part + n_bhs + bh * splits;
  const float* acc = part + 2 * n_bhs + bh * splits * D;
  const int d = threadIdx.x;
  // launched early (programmatic dependent launch): wait until the split
  // pass has ended and its partials are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");

  float m_all = kNegInf;
  for (int s = 0; s < splits; ++s) m_all = fmaxf(m_all, m[s]);
  float l_all = 0.f, o = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(m[s] - m_all);
    l_all = fmaf(l[s], w, l_all);
    o = fmaf(acc[size_t(s) * D + d], w, o);
  }
  store(out + bh * D + d, o / l_all);
}

template <typename QT, typename KT, int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* tables, const int* lens, float* part, void* out,
           int B, int H, int bs, int T, int pps, int splits, float scale,
           cudaStream_t stream) {
  const dim3 grid(splits, H, B);
  paged_decode_split_kernel<QT, KT, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), tables, lens, part, H, bs, T, pps,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the merge may start while the split pass ends: it waits on the
  // dependency itself (griddepcontrol.wait)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_decode_merge_kernel<QT, D>,
                           static_cast<const float*>(part),
                           static_cast<QT*>(out), splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int by_head_dim(int D, const void* q, const void* k_pages,
                const void* v_pages, const int* tables, const int* lens,
                float* part, void* out, int B, int H, int bs, int T, int pps,
                int splits, float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<QT, KT, 64>(q, k_pages, v_pages, tables, lens, part, out,
                                B, H, bs, T, pps, splits, scale, stream);
    case 128:
      return launch<QT, KT, 128>(q, k_pages, v_pages, tables, lens, part,
                                 out, B, H, bs, T, pps, splits, scale,
                                 stream);
    case 256:
      return launch<QT, KT, 256>(q, k_pages, v_pages, tables, lens, part,
                                 out, B, H, bs, T, pps, splits, scale,
                                 stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out [B,H,D] in q_dtype; k_pages, v_pages [P,bs,H,D] in kv_dtype (0 =
// fp32, 1 = bf16, each); tables [B,T] int32; lens [B] int32; part fp32
// scratch of B * H * splits * (D + 2) elements; all contiguous, 16-byte
// aligned, on the current device. pps pages a split, splits = ceil(T /
// pps). Returns the CUDA error of the launches (0 = cudaSuccess).
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* tables,
                            const void* lens, void* part, void* out, int B,
                            int H, int D, int bs, int T, int pps, int splits,
                            int q_dtype, int kv_dtype, float scale,
                            void* stream) {
  if (bs <= 0 || bs % 8 || T <= 0 || pps <= 0 || pps > kMaxSplitPages ||
      splits != (T + pps - 1) / pps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return static_cast<int>(cudaSuccess);
  const auto* tb = static_cast<const int*>(tables);
  const auto* ln = static_cast<const int*>(lens);
  auto* pt = static_cast<float*>(part);
  auto st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return by_head_dim<float, float>(D, q, k_pages, v_pages, tb, ln, pt, out,
                                     B, H, bs, T, pps, splits, scale, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return by_head_dim<float, bf16>(D, q, k_pages, v_pages, tb, ln, pt, out,
                                    B, H, bs, T, pps, splits, scale, st);
  if (q_dtype == 1 && kv_dtype == 0)
    return by_head_dim<bf16, float>(D, q, k_pages, v_pages, tb, ln, pt, out,
                                    B, H, bs, T, pps, splits, scale, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_head_dim<bf16, bf16>(D, q, k_pages, v_pages, tb, ln, pt, out,
                                   B, H, bs, T, pps, splits, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
