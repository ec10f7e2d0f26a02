// Switch-MoE dispatch and combine for Hopper (sm_90a): token rows into
// expert slots and back, on fp32 or bf16 rows with fp32 arithmetic.
//
// Replaces the two Pallas TPU kernels of paddle_operator_tpu/ops/moe.py:
//   moe_dispatch_kernel <- _dispatch_kernel (B4a, launched by _dispatch_call)
//   moe_combine_kernel  <- _combine_kernel  (B4b, launched by _combine_call)
//
// What they compute, with choice[t] the token's expert and pos[t] its
// position in that expert's queue (int64, from the routing in
// ops/moe.py), and a token kept when 0 <= choice < E and 0 <= pos < C:
//   dispatch: out[e, c, :] = x[t, :] for the kept token with
//             (choice, pos) = (e, c); zero for a slot no token fills.
//             x [T, D] -> out [E, C, D].
//   combine:  out[t, :] = gate[t] * eo[choice[t], pos[t], :] for a kept
//             token, an exact zero row for a dropped one; with no gate
//             (a null pointer) the row is copied. eo [E, C, D] -> [T, D].
// The TPU kernels rebuild a one-hot [block_t, C] tile in VMEM and contract
// it on the matrix unit; each output element there is one product with a
// one-hot row, i.e. one copy (dispatch) or one product gate * row
// (combine), accumulated in fp32 and converted once. Here each element is
// the same copy or the same single product (__fmul_rn, never contracted
// into an FMA) and the same conversion (__float2bfloat16_rn), so both
// kernels are bitwise equal to their plain versions in ops/moe.py.
//
// Types (in -> out): dispatch bf16 -> bf16, fp32 -> bf16, fp32 -> fp32;
// combine bf16 -> bf16, bf16 -> fp32, fp32 -> fp32 (what the forward and
// the backward of ops/moe.py's autograd Functions pass).
//
// Bound: memory. Each kept token moves one row in and one row out, with
// no arithmetic to speak of (one product per element in combine); the
// least time is the bytes over the HBM rate: kept rows read plus the
// whole output written (the zero slots and dropped rows included) plus
// the routing metadata. GPT-2 small with 8 experts (T = 16384, D = 768,
// C = 2560, bf16): about 25 MB in and 31 MB (dispatch) or 25 MB
// (combine) out, 0.015-0.017 ms at 3.35 TB/s.
//
// Design (simple and right first; 16-byte vector rows, and dropping the
// zero fill, are later work):
//  * one block of 256 threads per token; consecutive threads touch
//    consecutive elements of the row, so loads and stores coalesce;
//  * each kept token owns exactly one (e, c) slot (positions come from a
//    cumulative count), so dispatch scatters with plain stores: no atomics,
//    no order between blocks matters, the result is deterministic;
//  * dispatch's empty slots are zeroed first by a cudaMemsetAsync of the
//    output on the same stream (the TPU kernel zeroes its accumulator);
//  * the TPU's 128-lane replication of the routing metadata, its capacity
//    padding to 128 and its token padding to the tile are layout rules of
//    that chip and are dropped: any T, D, E and C;
//  * offsets are 64-bit.
//
// Every entry point launches on the given stream, allocates and
// synchronises nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a type or size it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kF32 = 0;   // ops/moe.py _KERNEL_DTYPES
constexpr int kBF16 = 1;

__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i,
                                      float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool kept(long long e, long long c, int experts,
                                     long long capacity) {
  return e >= 0 && e < experts && c >= 0 && c < capacity;
}

template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
moe_dispatch_kernel(const In* __restrict__ x,
                    const long long* __restrict__ choice,
                    const long long* __restrict__ pos, Out* __restrict__ out,
                    long long dim, int experts, long long capacity) {
  const long long t = blockIdx.x;
  const long long e = choice[t];
  const long long c = pos[t];
  if (!kept(e, c, experts, capacity)) return;
  const In* src = x + t * dim;
  Out* dst = out + (e * capacity + c) * dim;
  for (long long d = threadIdx.x; d < dim; d += kThreads) {
    store(dst, d, load(src, d));
  }
}

template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
moe_combine_kernel(const In* __restrict__ eo,
                   const long long* __restrict__ choice,
                   const long long* __restrict__ pos,
                   const float* __restrict__ gate, Out* __restrict__ out,
                   long long dim, int experts, long long capacity) {
  const long long t = blockIdx.x;
  const long long e = choice[t];
  const long long c = pos[t];
  Out* dst = out + t * dim;
  if (!kept(e, c, experts, capacity)) {
    for (long long d = threadIdx.x; d < dim; d += kThreads) {
      store(dst, d, 0.0f);
    }
    return;
  }
  const In* src = eo + (e * capacity + c) * dim;
  if (gate == nullptr) {
    for (long long d = threadIdx.x; d < dim; d += kThreads) {
      store(dst, d, load(src, d));
    }
  } else {
    const float g = gate[t];
    for (long long d = threadIdx.x; d < dim; d += kThreads) {
      store(dst, d, __fmul_rn(load(src, d), g));
    }
  }
}

bool sizes_ok(long long tokens, long long dim, int experts,
              long long capacity) {
  // one block per token: the grid's x dimension holds up to 2^31 - 1
  return tokens >= 0 && tokens < (1LL << 31) && dim >= 1 && experts >= 1 &&
         capacity >= 1;
}

template <typename In, typename Out>
int dispatch(const void* x, const void* choice, const void* pos, void* out,
             long long tokens, long long dim, int experts,
             long long capacity, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(experts) *
                       static_cast<size_t>(capacity) *
                       static_cast<size_t>(dim) * sizeof(Out);
  cudaError_t err = cudaMemsetAsync(out, 0, bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tokens == 0) return static_cast<int>(cudaGetLastError());
  moe_dispatch_kernel<In, Out>
      <<<static_cast<unsigned int>(tokens), kThreads, 0, stream>>>(
          static_cast<const In*>(x), static_cast<const long long*>(choice),
          static_cast<const long long*>(pos), static_cast<Out*>(out), dim,
          experts, capacity);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, typename Out>
int combine(const void* eo, const void* choice, const void* pos,
            const void* gate, void* out, long long tokens, long long dim,
            int experts, long long capacity, cudaStream_t stream) {
  if (tokens == 0) return static_cast<int>(cudaSuccess);
  moe_combine_kernel<In, Out>
      <<<static_cast<unsigned int>(tokens), kThreads, 0, stream>>>(
          static_cast<const In*>(eo), static_cast<const long long*>(choice),
          static_cast<const long long*>(pos),
          static_cast<const float*>(gate), static_cast<Out*>(out), dim,
          experts, capacity);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [tokens, dim] of in_type; choice, pos [tokens] int64; out [experts,
// capacity, dim] of out_type, written whole. Types: 0 = fp32, 1 = bf16.
extern "C" int moe_dispatch(const void* x, const void* choice,
                            const void* pos, void* out, long long tokens,
                            long long dim, int experts, long long capacity,
                            int in_type, int out_type, void* stream) {
  if (!sizes_ok(tokens, dim, experts, capacity)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_type == kBF16 && out_type == kBF16) {
    return dispatch<__nv_bfloat16, __nv_bfloat16>(x, choice, pos, out, tokens,
                                                  dim, experts, capacity, s);
  }
  if (in_type == kF32 && out_type == kBF16) {
    return dispatch<float, __nv_bfloat16>(x, choice, pos, out, tokens, dim,
                                          experts, capacity, s);
  }
  if (in_type == kF32 && out_type == kF32) {
    return dispatch<float, float>(x, choice, pos, out, tokens, dim, experts,
                                  capacity, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// eo [experts, capacity, dim] of in_type; choice, pos [tokens] int64; gate
// [tokens] fp32 or null (no product); out [tokens, dim] of out_type.
extern "C" int moe_combine(const void* eo, const void* choice,
                           const void* pos, const void* gate, void* out,
                           long long tokens, long long dim, int experts,
                           long long capacity, int in_type, int out_type,
                           void* stream) {
  if (!sizes_ok(tokens, dim, experts, capacity)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_type == kBF16 && out_type == kBF16) {
    return combine<__nv_bfloat16, __nv_bfloat16>(
        eo, choice, pos, gate, out, tokens, dim, experts, capacity, s);
  }
  if (in_type == kBF16 && out_type == kF32) {
    return combine<__nv_bfloat16, float>(eo, choice, pos, gate, out, tokens,
                                         dim, experts, capacity, s);
  }
  if (in_type == kF32 && out_type == kF32) {
    return combine<float, float>(eo, choice, pos, gate, out, tokens, dim,
                                 experts, capacity, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
