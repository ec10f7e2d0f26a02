// Multi-tensor fused SGD update (decay + momentum + parameter write), fp32,
// for Hopper (sm_90a).
//
// Replaces paddle_operator_tpu/ops/optim.py::_fused_sgd_kernel (the Pallas
// TPU kernel behind fused_sgd).
//
// What it computes, for every element of every leaf, in place:
//   g' = g + decay * p          (skipped where the leaf's decay is 0)
//   m  = mu * m + g'
//   d  = nesterov ? g' + mu * m : m
//   p  = p - lr * d
// A leaf whose grad pointer is null (a parameter autograd never reached,
// such as a BatchNorm running stat) has g = 0. lr is read from a 0-d fp32
// device tensor, so the host never syncs for it and the launch could be
// captured in a CUDA graph.
//
// Rounding: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn, which nvcc never contracts into an FMA), the
// operation order of the plain PyTorch version in ops/optim.py. The kernel is
// therefore bitwise equal to it, not only at the first step.
//
// Bound: memory. Per element it reads p, g, m and writes p, m (20 bytes) for
// about 6 flops, so the least time is 20 bytes per element over the HBM rate
// (ResNet-50: 25.6M elements, 0.51 GB, 0.153 ms at 3.35 TB/s).
//
// Design (a simple kernel that is right; vector loads and a tuned chunk size
// are later work):
//  * ONE launch per optimizer step over all leaves. A device table holds one
//    int64 row per leaf: p, g, m pointers, element count, the decay's fp32
//    bits and the index of the leaf's first chunk. The TPU kernel needed the
//    leaves concatenated and padded into one [rows, 128] buffer (and copied
//    back out); here each leaf is read where it lies;
//  * each block of kThreads threads updates one chunk of kChunk elements of
//    one leaf (chunks never straddle leaves). Thread 0 finds the block's
//    leaf by a binary search over the first-chunk column; consecutive
//    threads touch consecutive elements, so every access is coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;    // ops/optim.py _CHUNK
constexpr int kCols = 6;        // ops/optim.py _TABLE_COLS

__global__ void __launch_bounds__(kThreads)
fused_sgd_kernel(const long long* __restrict__ table, int n_leaves,
                 const float* __restrict__ lr_ptr, float mu, int nesterov) {
  __shared__ int leaf_s;
  const long long chunk = blockIdx.x;
  if (threadIdx.x == 0) {
    int lo = 0, hi = n_leaves - 1;   // last leaf whose first chunk <= chunk
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (table[static_cast<long long>(mid) * kCols + 5] <= chunk) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    leaf_s = lo;
  }
  __syncthreads();
  const long long* row = table + static_cast<long long>(leaf_s) * kCols;
  float* p = reinterpret_cast<float*>(row[0]);
  const float* g = reinterpret_cast<const float*>(row[1]);
  float* m = reinterpret_cast<float*>(row[2]);
  const long long n = row[3];
  const float decay = __int_as_float(static_cast<int>(row[4]));
  const long long start = (chunk - row[5]) * kChunk;
  const long long end = start + kChunk < n ? start + kChunk : n;
  const float lr = *lr_ptr;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float pi = p[i];
    float gi = g != nullptr ? g[i] : 0.0f;
    if (decay != 0.0f) gi = __fadd_rn(gi, __fmul_rn(decay, pi));
    const float mi = __fadd_rn(__fmul_rn(mu, m[i]), gi);
    const float d = nesterov ? __fadd_rn(gi, __fmul_rn(mu, mi)) : mi;
    p[i] = __fsub_rn(pi, __fmul_rn(lr, d));
    m[i] = mi;
  }
}

}  // namespace

// table: [n_leaves, 6] int64 on the device (see above); n_chunks: the total
// number of kChunk chunks over all leaves (the grid size); lr: 0-d fp32 on
// the device. Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int fused_sgd_f32(const void* table, int n_leaves,
                             long long n_chunks, const void* lr, float mu,
                             int nesterov, void* stream) {
  if (n_leaves == 0 || n_chunks == 0) return static_cast<int>(cudaSuccess);
  fused_sgd_kernel<<<static_cast<unsigned int>(n_chunks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), n_leaves,
      static_cast<const float*>(lr), mu, nesterov);
  return static_cast<int>(cudaGetLastError());
}
