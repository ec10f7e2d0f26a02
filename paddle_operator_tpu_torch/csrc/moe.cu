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
//   dispatch: out[e, c, :] = scale[t] * x[t, :] for the kept token with
//             (choice, pos) = (e, c); zero for a slot no token fills.
//             x [T, D] -> out [E, C, D]. With no scale (a null pointer)
//             the row is copied. Combine's backward passes the gate as
//             the scale: the dispatch of gate * cotangent, fused.
//   combine:  out[t, :] = gate[t] * eo[choice[t], pos[t], :] for a kept
//             token, an exact +0.0 row for a dropped one; with no gate
//             (a null pointer) the row is copied. eo [E, C, D] -> [T, D].
// The TPU kernels rebuild a one-hot [block_t, C] tile in VMEM and contract
// it on the matrix unit; each output element there is one product with a
// one-hot row, i.e. one copy or one product gate * row, accumulated in
// fp32 and converted once. Here each element is the same copy or the same
// single product (__fmul_rn, never contracted into an FMA) and the same
// round-to-nearest conversion (__floats2bfloat162_rn rounds each half as
// __float2bfloat16_rn does), so both kernels are bitwise equal to their
// plain versions in ops/moe.py.
//
// Types (in -> out): bf16 -> bf16 and fp32 -> fp32 for both, fp32 ->
// bf16 for dispatch, bf16 -> fp32 for combine; each with or without its
// scale or gate. (Combine's backward dispatches the cotangent, in the
// type of combine's output, into the type of combine's input.)
//
// Bound: memory. Each kept token moves one row in and one row out, with at
// most one product per element; the least time is the bytes over the HBM
// rate: kept rows read once, the whole output written once (empty slots
// and dropped rows included), the int64 routing and the fp32 gate or
// scale read once. GPT-2 small with 8 experts (T = 16384, D = 768, C =
// 2560, bf16): dispatch 56.9 MB (0.0170 ms at 3.35 TB/s), combine 50.7 MB
// (0.0151 ms).
//
// Design:
//  * one warp per row (a token row in combine, a slot row in dispatch),
//    kRows rows a warp at a time; the routing of those rows is read once,
//    by lane r for row r, and broadcast with __shfl_sync;
//  * the vector path moves 16-byte chunks of 8 elements (one 16-byte
//    access of bf16, two of fp32): lane l takes chunks l, l + 32, ... of
//    each row, so a warp's access covers 512 contiguous bytes. A warp
//    issues every load of its rows (read-only path, ld.global.nc) before
//    its first store, so 2 rows x up to 4 chunks a lane are in flight;
//  * a row that is not a whole number of chunks, or a pointer that is not
//    16-byte aligned, takes the scalar path of the same kernel (one
//    element a lane per access, the same loads-before-stores order); the
//    wrapper chooses the path and says which in `vec`;
//  * dispatch is a gather with no zero fill: moe_slot_table_kernel
//    writes t into an inverse slot table (int32 [E * C], the wrapper's
//    scratch, never cleared) at choice * C + pos for each kept token (no
//    two kept tokens share a slot: positions come from a cumulative
//    count), and the gather writes every output row exactly once, in
//    order: the kept token's row or zeros. An entry counts only if it
//    names a token in [0, T) whose own routing is kept at this slot: a
//    slot some token owns was written by that token, so a stale or
//    uninitialised entry can only fail the check, and no fill of the
//    table is needed. Two device operations a call; the gather is a
//    programmatic dependent launch, scheduled while the table kernel
//    runs, that waits (griddepcontrol.wait) before its first read;
//  * the grid covers every row, kWarps * kRows rows a block (a
//    persistent grid of 2, 4 or 8 blocks an SM that strides over the
//    rows measured no faster on an H100);
//  * no atomics: the result does not depend on the order of the blocks;
//  * the TPU's 128-lane replication of the routing metadata, its capacity
//    padding to 128 and its token padding to the tile are layout rules of
//    that chip and are dropped: any T, D, E and C. Offsets are 64-bit.
//
// Every entry point launches on the given stream, allocates and
// synchronises nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a type, size or alignment it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;                 // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 2;                  // rows a warp moves at a time
constexpr int kChunks = 4;                // chunks (elements, scalar) a lane
                                          // loads per row before storing
constexpr int kVec = 8;                   // elements of a chunk
constexpr int kTableThreads = 256;
constexpr int kF32 = 0;                   // ops/moe.py _KERNEL_DTYPES
constexpr int kBF16 = 1;
constexpr unsigned kFull = 0xffffffffu;

// ---- one chunk of 8 elements: raw 16-byte words, loaded read-only -------

template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* row,
                                       long long i) {
    w = __ldg(reinterpret_cast<const uint4*>(row) + i);
  }
  // bf16 -> fp32 is exact: the 16 bits are the float's upper half
  __device__ __forceinline__ void to_float(float (&f)[kVec]) const {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(u[j] << 16);
      f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
};

template <>
struct Chunk<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* row, long long i) {
    const float4* p = reinterpret_cast<const float4*>(row) + 2 * i;
    a = __ldg(p);
    b = __ldg(p + 1);
  }
  __device__ __forceinline__ void to_float(float (&f)[kVec]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void store_chunk(__nv_bfloat16* row, long long i,
                                            const float (&f)[kVec]) {
  reinterpret_cast<uint4*>(row)[i] =
      make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                 pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}

__device__ __forceinline__ void store_chunk(float* row, long long i,
                                            const float (&f)[kVec]) {
  float4* p = reinterpret_cast<float4*>(row) + 2 * i;
  p[0] = make_float4(f[0], f[1], f[2], f[3]);
  p[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// ---- one element (the scalar path) --------------------------------------

__device__ __forceinline__ float load1(const float* row, long long i) {
  return __ldg(row + i);
}
__device__ __forceinline__ float load1(const __nv_bfloat16* row,
                                       long long i) {
  const unsigned short u =
      __ldg(reinterpret_cast<const unsigned short*>(row) + i);
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ void store1(float* row, long long i, float v) {
  row[i] = v;
}
__device__ __forceinline__ void store1(__nv_bfloat16* row, long long i,
                                       float v) {
  row[i] = __float2bfloat16_rn(v);
}

// ---- a warp moves kRows rows ---------------------------------------------

// dst[r] = convert(scale[r] * src[r]) (no product unless kScaled), zeros
// where src[r] is null; rows whose dst[r] is null are past the end. The
// vector path takes rows of n = D / 8 chunks, the scalar one of n = D
// elements. Every load of a pass is issued before its first store.
template <typename In, typename Out, bool kScaled>
__device__ __forceinline__ void move_rows_vec(const In* const (&src)[kRows],
                                              const float (&scale)[kRows],
                                              Out* const (&dst)[kRows],
                                              long long n, int lane) {
  for (long long base = lane; base < n; base += 32 * kChunks) {
    Chunk<In> c[kRows][kChunks];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const long long i = base + 32 * k;
        if (src[r] != nullptr && i < n) c[r][k].load(src[r], i);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const long long i = base + 32 * k;
        if (dst[r] == nullptr || i >= n) continue;
        float f[kVec];
        if (src[r] != nullptr) {
          c[r][k].to_float(f);
          if (kScaled) {
#pragma unroll
            for (int j = 0; j < kVec; ++j) f[j] = __fmul_rn(f[j], scale[r]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) f[j] = 0.0f;
        }
        store_chunk(dst[r], i, f);
      }
    }
  }
}

template <typename In, typename Out, bool kScaled>
__device__ __forceinline__ void move_rows_scalar(
    const In* const (&src)[kRows], const float (&scale)[kRows],
    Out* const (&dst)[kRows], long long n, int lane) {
  for (long long base = lane; base < n; base += 32 * kChunks) {
    float v[kRows][kChunks];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const long long i = base + 32 * k;
        v[r][k] = (src[r] != nullptr && i < n) ? load1(src[r], i) : 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const long long i = base + 32 * k;
        if (dst[r] == nullptr || i >= n) continue;
        const float f = (kScaled && src[r] != nullptr)
                            ? __fmul_rn(v[r][k], scale[r]) : v[r][k];
        store1(dst[r], i, f);
      }
    }
  }
}

// Rows [row0, row0 + kRows) of the output: lane r < kRows has read row
// row0 + r's source row index (-1: zeros) and scale; every lane takes
// them by shuffle and the warp moves the rows.
template <typename In, typename Out, bool kScaled>
__device__ __forceinline__ void move_warp_rows(
    const In* __restrict__ in, Out* __restrict__ out, long long row0,
    long long rows, long long my_src, float my_scale, long long dim,
    bool vec, int lane) {
  const In* src[kRows];
  Out* dst[kRows];
  float scale[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long s = __shfl_sync(kFull, my_src, r);
    scale[r] = __shfl_sync(kFull, my_scale, r);
    src[r] = s >= 0 ? in + s * dim : nullptr;
    dst[r] = row0 + r < rows ? out + (row0 + r) * dim : nullptr;
  }
  if (vec) {
    move_rows_vec<In, Out, kScaled>(src, scale, dst, dim / kVec, lane);
  } else {
    move_rows_scalar<In, Out, kScaled>(src, scale, dst, dim, lane);
  }
}

__device__ __forceinline__ bool kept(long long e, long long c, int experts,
                                     long long capacity) {
  return e >= 0 && e < experts && c >= 0 && c < capacity;
}

// ---- the kernels ----------------------------------------------------------

template <typename In, typename Out, bool kScaled>
__global__ void __launch_bounds__(kThreads)
moe_combine_kernel(const In* __restrict__ eo,
                   const long long* __restrict__ choice,
                   const long long* __restrict__ pos,
                   const float* __restrict__ gate, Out* __restrict__ out,
                   long long tokens, long long dim, int experts,
                   long long capacity, bool vec) {
  const int lane = threadIdx.x & 31;
  const long long t0 =
      (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) *
      kRows;
  if (t0 >= tokens) return;  // the whole warp: t0 is the warp's
  long long my_src = -1;
  float my_gate = 0.0f;
  if (lane < kRows && t0 + lane < tokens) {
    const long long t = t0 + lane;
    const long long e = __ldg(choice + t);
    const long long c = __ldg(pos + t);
    if (kept(e, c, experts, capacity)) {
      my_src = e * capacity + c;
      if (kScaled) my_gate = __ldg(gate + t);
    }
  }
  move_warp_rows<In, Out, kScaled>(eo, out, t0, tokens, my_src, my_gate,
                                   dim, vec, lane);
}

__global__ void __launch_bounds__(kTableThreads)
moe_slot_table_kernel(const long long* __restrict__ choice,
                      const long long* __restrict__ pos,
                      int* __restrict__ table, long long tokens, int experts,
                      long long capacity) {
  // let the gather's blocks be scheduled now; they wait for this grid
  asm volatile("griddepcontrol.launch_dependents;");
  const long long t =
      static_cast<long long>(blockIdx.x) * kTableThreads + threadIdx.x;
  if (t >= tokens) return;
  const long long e = choice[t];
  const long long c = pos[t];
  if (kept(e, c, experts, capacity)) {
    table[e * capacity + c] = static_cast<int>(t);
  }
}

template <typename In, typename Out, bool kScaled>
__global__ void __launch_bounds__(kThreads)
moe_dispatch_kernel(const In* __restrict__ x, const int* __restrict__ table,
                    const long long* __restrict__ choice,
                    const long long* __restrict__ pos,
                    const float* __restrict__ scale, Out* __restrict__ out,
                    long long tokens, int experts, long long capacity,
                    long long dim, bool vec) {
  // launched early (programmatic dependent launch): wait until the table
  // kernel has ended and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long slots = static_cast<long long>(experts) * capacity;
  const int lane = threadIdx.x & 31;
  const long long s0 =
      (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) *
      kRows;
  if (s0 >= slots) return;  // the whole warp: s0 is the warp's
  long long my_src = -1;
  float my_scale = 0.0f;
  if (lane < kRows && s0 + lane < slots) {
    const long long slot = s0 + lane;
    const int t = table[slot];
    if (t >= 0 && t < tokens) {
      const long long e = __ldg(choice + t);
      const long long c = __ldg(pos + t);
      if (kept(e, c, experts, capacity) && e * capacity + c == slot) {
        my_src = t;
        if (kScaled) my_scale = __ldg(scale + t);
      }
    }
  }
  move_warp_rows<In, Out, kScaled>(x, out, s0, slots, my_src, my_scale,
                                   dim, vec, lane);
}

// ---- launches -------------------------------------------------------------

bool sizes_ok(long long tokens, long long dim, int experts,
              long long capacity) {
  // tokens fit the int32 slot table; rows / (kWarps * kRows) blocks fit
  // the grid's x dimension (2^31 - 1)
  return tokens >= 0 && tokens < (1LL << 31) && dim >= 1 && experts >= 1 &&
         capacity >= 1 && capacity < (1LL << 35) / experts;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the vector path needs whole chunks and 16-byte aligned rows
bool vec_ok(bool vec, long long dim, const void* a, const void* b) {
  return !vec || (dim % kVec == 0 && aligned(a) && aligned(b));
}

// blocks of a grid that covers `rows` rows
unsigned int row_blocks(long long rows) {
  const long long per_block = kWarps * kRows;
  return static_cast<unsigned int>((rows + per_block - 1) / per_block);
}

template <typename In, typename Out, bool kScaled>
int dispatch(const void* x, const void* choice, const void* pos,
             const void* scale, void* table, void* out, long long tokens,
             long long dim, int experts, long long capacity, bool vec,
             cudaStream_t stream) {
  const long long slots = static_cast<long long>(experts) * capacity;
  int* tab = static_cast<int*>(table);
  const auto* ch = static_cast<const long long*>(choice);
  const auto* ps = static_cast<const long long*>(pos);
  if (tokens > 0) {
    moe_slot_table_kernel<<<static_cast<unsigned int>(
                                (tokens + kTableThreads - 1) / kTableThreads),
                            kTableThreads, 0, stream>>>(ch, ps, tab, tokens,
                                                        experts, capacity);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the gather as a programmatic dependent launch: the kernel waits for
  // the table kernel itself (griddepcontrol.wait)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_blocks(slots));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, moe_dispatch_kernel<In, Out, kScaled>,
      static_cast<const In*>(x), static_cast<const int*>(tab), ch, ps,
      static_cast<const float*>(scale), static_cast<Out*>(out), tokens,
      experts, capacity, dim, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, typename Out, bool kScaled>
int combine(const void* eo, const void* choice, const void* pos,
            const void* gate, void* out, long long tokens, long long dim,
            int experts, long long capacity, bool vec, cudaStream_t stream) {
  if (tokens == 0) return static_cast<int>(cudaSuccess);
  moe_combine_kernel<In, Out, kScaled>
      <<<row_blocks(tokens), kThreads, 0, stream>>>(
          static_cast<const In*>(eo), static_cast<const long long*>(choice),
          static_cast<const long long*>(pos),
          static_cast<const float*>(gate), static_cast<Out*>(out), tokens,
          dim, experts, capacity, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, typename Out>
int dispatch_of(bool scaled, const void* x, const void* choice,
                const void* pos, const void* scale, void* table, void* out,
                long long tokens, long long dim, int experts,
                long long capacity, bool vec, cudaStream_t s) {
  return scaled ? dispatch<In, Out, true>(x, choice, pos, scale, table, out,
                                          tokens, dim, experts, capacity,
                                          vec, s)
                : dispatch<In, Out, false>(x, choice, pos, scale, table, out,
                                           tokens, dim, experts, capacity,
                                           vec, s);
}

template <typename In, typename Out>
int combine_of(bool gated, const void* eo, const void* choice,
               const void* pos, const void* gate, void* out,
               long long tokens, long long dim, int experts,
               long long capacity, bool vec, cudaStream_t s) {
  return gated ? combine<In, Out, true>(eo, choice, pos, gate, out, tokens,
                                        dim, experts, capacity, vec, s)
               : combine<In, Out, false>(eo, choice, pos, gate, out, tokens,
                                         dim, experts, capacity, vec, s);
}

}  // namespace

// x [tokens, dim] of in_type; choice, pos [tokens] int64; scale [tokens]
// fp32 or null (no product); table int32 [experts * capacity], scratch
// of any content;
// out [experts, capacity, dim] of out_type, written whole. Types: 0 =
// fp32, 1 = bf16. vec: the 16-byte path (dim a multiple of 8, x and out
// 16-byte aligned), else the scalar one.
extern "C" int moe_dispatch(const void* x, const void* choice,
                            const void* pos, const void* scale, void* table,
                            void* out, long long tokens, long long dim,
                            int experts, long long capacity, int in_type,
                            int out_type, int vec, void* stream) {
  if (!sizes_ok(tokens, dim, experts, capacity) ||
      !vec_ok(vec != 0, dim, x, out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool scaled = scale != nullptr;
  if (in_type == kBF16 && out_type == kBF16) {
    return dispatch_of<__nv_bfloat16, __nv_bfloat16>(
        scaled, x, choice, pos, scale, table, out, tokens, dim, experts,
        capacity, vec != 0, s);
  }
  if (in_type == kF32 && out_type == kBF16) {
    return dispatch_of<float, __nv_bfloat16>(
        scaled, x, choice, pos, scale, table, out, tokens, dim, experts,
        capacity, vec != 0, s);
  }
  if (in_type == kF32 && out_type == kF32) {
    return dispatch_of<float, float>(scaled, x, choice, pos, scale, table,
                                     out, tokens, dim, experts, capacity,
                                     vec != 0, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// eo [experts, capacity, dim] of in_type; choice, pos [tokens] int64; gate
// [tokens] fp32 or null (no product); out [tokens, dim] of out_type. vec
// as for moe_dispatch.
extern "C" int moe_combine(const void* eo, const void* choice,
                           const void* pos, const void* gate, void* out,
                           long long tokens, long long dim, int experts,
                           long long capacity, int in_type, int out_type,
                           int vec, void* stream) {
  if (!sizes_ok(tokens, dim, experts, capacity) ||
      !vec_ok(vec != 0, dim, eo, out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool gated = gate != nullptr;
  if (in_type == kBF16 && out_type == kBF16) {
    return combine_of<__nv_bfloat16, __nv_bfloat16>(
        gated, eo, choice, pos, gate, out, tokens, dim, experts, capacity,
        vec != 0, s);
  }
  if (in_type == kBF16 && out_type == kF32) {
    return combine_of<__nv_bfloat16, float>(gated, eo, choice, pos, gate,
                                            out, tokens, dim, experts,
                                            capacity, vec != 0, s);
  }
  if (in_type == kF32 && out_type == kF32) {
    return combine_of<float, float>(gated, eo, choice, pos, gate, out,
                                    tokens, dim, experts, capacity, vec != 0,
                                    s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
