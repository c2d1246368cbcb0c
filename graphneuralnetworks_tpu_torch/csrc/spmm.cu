// CSR sparse x dense products for message passing: K1 (SpMM) and K2 (the
// fused weighted-SpMM backward), float32, for sm_90a.
//
// Both kernels walk a compressed-sparse-row edge grouping:
//   indptr int32[n_rows + 1]   edges of row i are positions [indptr[i], indptr[i+1])
//   col    int32[E]            the row of the dense operand each position reads
//   eid    int32[E] or NULL    the original edge id of each position (NULL: identity)
//   w      float[E] or NULL    per-edge weights, indexed by original edge id
//
// Layout: one warp owns one output row. The row's D floats are split into
// vectors (float4 when D % 4 == 0 and the pointers are 16-byte aligned, else
// single floats). When a row has fewer than 32 vectors, the warp splits into
// groups of G lanes (G = next power of two >= the vector count) and the
// 32 / G groups take interleaved edges; one shuffle tree at the end adds the
// groups' partial sums. Wider rows loop over 32-vector chunks. Each warp
// loads 32 edge indices at once and broadcasts them with __shfl_sync.
//
// Every output row is written exactly once by one warp, so no atomics are
// needed and the summation order is fixed: results are bitwise reproducible
// from run to run. Rows with no edges are written as zeros.
//
// Bound on an H100: memory. Each edge costs one gathered row of D floats
// (E*D*4 bytes, ~1.1 GB at E=2M, D=128) against 2*D flops, far below the
// card's ~20 flops/byte balance point. The compulsory traffic (each input
// and output once) is far smaller than the gathered traffic, so the reuse of
// gathered rows in the 50 MB L2 decides where between the two the kernel
// lands. The design keeps every gathered load a full 16-byte vector per lane
// and a whole row per warp (coalesced 512-byte reads at D=128), keeps the
// accumulator in registers, and writes each output row once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

template <typename V> __device__ __forceinline__ V vzero();
template <> __device__ __forceinline__ float vzero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void axpy(float& a, float w, float v) {
  a = fmaf(w, v, a);
}
__device__ __forceinline__ void axpy(float4& a, float w, const float4& v) {
  a.x = fmaf(w, v.x, a.x);
  a.y = fmaf(w, v.y, a.y);
  a.z = fmaf(w, v.z, a.z);
  a.w = fmaf(w, v.w, a.w);
}

__device__ __forceinline__ float vdot(float a, float b) { return a * b; }
__device__ __forceinline__ float vdot(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void add_xor(float& a, int off) {
  a += __shfl_xor_sync(kFull, a, off);
}
__device__ __forceinline__ void add_xor(float4& a, int off) {
  a.x += __shfl_xor_sync(kFull, a.x, off);
  a.y += __shfl_xor_sync(kFull, a.y, off);
  a.z += __shfl_xor_sync(kFull, a.z, off);
  a.w += __shfl_xor_sync(kFull, a.w, off);
}

// K1, replacing graphneuralnetworks_tpu/ops/pallas/spmm.py:_scatter_kernel
// (the one-hot x message-block MXU scatter over 128x512 receiver blocks).
//   y[i] = sum_{k in row i} w[eid[k]] * x[col[k]]
// Run over the receiver CSR it is the forward SpMM; over the sender CSR
// (with eid) it is the backward for x; with col == NULL over dy rows in edge
// order it is the backward of an endpoint gather.
template <typename V>
__global__ void __launch_bounds__(kThreads)
spmm_csr_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                const int* __restrict__ eid, const float* __restrict__ w,
                const V* __restrict__ x, V* __restrict__ y, int n_rows,
                int dv, int log_g) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // warp-uniform: the whole warp leaves
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;    // lanes per edge group
  const int p = 32 >> log_g;   // edge groups per warp
  const int grp = lane >> log_g;
  const int sub = lane & (g - 1);
  const int beg = indptr[row];
  const int end = indptr[row + 1];
  for (int c0 = 0; c0 < dv; c0 += g) {
    const int f = c0 + sub;
    const bool active = f < dv;
    V acc = vzero<V>();
    for (int base = beg; base < end; base += 32) {
      const int e = base + lane;
      int my_col = 0;
      float my_w = 0.f;
      if (e < end) {
        my_col = col ? col[e] : e;
        my_w = w ? w[eid ? eid[e] : e] : 1.f;
      }
      const int cnt = min(32, end - base);
      for (int j0 = 0; j0 < cnt; j0 += p) {  // warp-uniform trip count
        const int j = j0 + grp;                // < 32 since 32 % p == 0
        const int c = __shfl_sync(kFull, my_col, j);
        const float wj = __shfl_sync(kFull, my_w, j);
        if (active && j < cnt) axpy(acc, wj, x[(long long)c * dv + f]);
      }
    }
    for (int off = g; off < 32; off <<= 1) add_xor(acc, off);
    if (active && grp == 0) y[(long long)row * dv + f] = acc;
  }
}

// K2, replacing graphneuralnetworks_tpu/ops/pallas/spmm.py:
// _scatter_sddmm_kernel. Over the sender CSR (row s = a source node):
//   dx[s]      = sum_{k in row s} w[eid[k]] * dy[col[k]]
//   dw[eid[k]] = <dy[col[k]], x[s]>          (unweighted)
// in one sweep: each gathered dy row feeds both the dx sum and the dot with
// x[s], which the warp holds in registers for the whole row.
template <typename V>
__global__ void __launch_bounds__(kThreads)
spmm_sddmm_csr_kernel(const int* __restrict__ indptr,
                      const int* __restrict__ col,
                      const int* __restrict__ eid,
                      const float* __restrict__ w,
                      const V* __restrict__ dy, const V* __restrict__ x,
                      V* __restrict__ dx, float* __restrict__ dw, int n_rows,
                      int dv, int log_g) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;
  const int p = 32 >> log_g;
  const int grp = lane >> log_g;
  const int sub = lane & (g - 1);
  const int beg = indptr[row];
  const int end = indptr[row + 1];
  for (int c0 = 0; c0 < dv; c0 += g) {
    const int f = c0 + sub;
    const bool active = f < dv;
    const V xs = active ? x[(long long)row * dv + f] : vzero<V>();
    V acc = vzero<V>();
    for (int base = beg; base < end; base += 32) {
      const int e = base + lane;
      int my_col = 0, my_eid = 0;
      float my_w = 0.f;
      if (e < end) {
        my_col = col[e];
        my_eid = eid ? eid[e] : e;
        my_w = w ? w[my_eid] : 1.f;
      }
      const int cnt = min(32, end - base);
      for (int j0 = 0; j0 < cnt; j0 += p) {
        const int j = j0 + grp;
        const int c = __shfl_sync(kFull, my_col, j);
        const int ej = __shfl_sync(kFull, my_eid, j);
        const float wj = __shfl_sync(kFull, my_w, j);
        const bool ok = j < cnt;
        const V v = (active && ok) ? dy[(long long)c * dv + f] : vzero<V>();
        axpy(acc, wj, v);
        float dot = vdot(v, xs);
        for (int off = 1; off < g; off <<= 1) dot += __shfl_xor_sync(kFull, dot, off);
        // Chunks after the first add to the partial dot; the same lane owns
        // edge j in every chunk, so the read-modify-write never races.
        if (ok && sub == 0) dw[ej] = (c0 == 0) ? dot : dw[ej] + dot;
      }
    }
    for (int off = g; off < 32; off <<= 1) add_xor(acc, off);
    if (active && grp == 0) dx[(long long)row * dv + f] = acc;
  }
}

int log_group(int dv) {
  int lg = 0;
  while ((1 << lg) < dv && lg < 5) ++lg;
  return lg;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int blocks_for(int n_rows) { return (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). The caller
// allocates y [n_rows, d] and makes sure n_rows > 0 and d > 0.
int spmm_csr_f32(const int* indptr, const int* col, const int* eid,
                 const float* w, const float* x, float* y, int n_rows, int d,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(x) && aligned16(y)) {
    const int dv = d / 4;
    spmm_csr_kernel<float4><<<blocks_for(n_rows), kThreads, 0, s>>>(
        indptr, col, eid, w, reinterpret_cast<const float4*>(x),
        reinterpret_cast<float4*>(y), n_rows, dv, log_group(dv));
  } else {
    spmm_csr_kernel<float><<<blocks_for(n_rows), kThreads, 0, s>>>(
        indptr, col, eid, w, x, y, n_rows, d, log_group(d));
  }
  return static_cast<int>(cudaGetLastError());
}

// dx [n_rows, d] and dw [E] are allocated by the caller; every entry of both
// is written.
int spmm_sddmm_csr_f32(const int* indptr, const int* col, const int* eid,
                       const float* w, const float* dy, const float* x,
                       float* dx, float* dw, int n_rows, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(dy) && aligned16(x) && aligned16(dx)) {
    const int dv = d / 4;
    spmm_sddmm_csr_kernel<float4><<<blocks_for(n_rows), kThreads, 0, s>>>(
        indptr, col, eid, w, reinterpret_cast<const float4*>(dy),
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(dx), dw,
        n_rows, dv, log_group(dv));
  } else {
    spmm_sddmm_csr_kernel<float><<<blocks_for(n_rows), kThreads, 0, s>>>(
        indptr, col, eid, w, dy, x, dx, dw, n_rows, d, log_group(d));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
