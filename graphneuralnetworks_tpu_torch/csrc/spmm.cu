// CSR sparse x dense products for message passing: K1 (SpMM) and K2 (the
// fused weighted-SpMM backward), float32, for sm_90a.
//
// Both kernels walk a compressed-sparse-row edge grouping:
//   indptr int32[n_rows + 1]   edges of row i are positions [indptr[i], indptr[i+1])
//   col    int32[E]            the row of the dense operand each position reads
//   eid    int32[E] or NULL    the original edge id of each position (NULL: identity)
//   w      float[E] or NULL    per-edge weights, indexed by original edge id
//
// A row's D floats are split into vectors (float4 when D % 4 == 0 and the
// pointers are 16-byte aligned, else single floats), and G lanes (the vector
// count rounded up to a power of two, at most 32) cover a row's width, or a
// chunk of 32 vectors of a wider row.
//
// K2's layout: one warp owns one output row; when a row has fewer than 32
// vectors the warp splits into 32 / G groups that take interleaved edges,
// and one shuffle tree at the end adds the groups' partial sums. Wider rows
// loop over 32-vector chunks. Each warp loads 32 edge indices at once and
// broadcasts them with __shfl_sync.
//
// K1's layout (see spmm_csr_kernel): a row's vectors split into strips of
// S = 2^log_strip vectors (at most G), one strip per block column, so the
// grid runs strip after strip over all rows; a warp takes R = 2^log_rows
// consecutive rows of one strip, each row owning 32 / R lanes, which split
// into edge groups of S lanes. The row's lanes load a window of 32 / R edge
// indices (and weights) at once, one per lane, and load the next window's
// while the current one's rows are gathered; each group issues U gathers,
// broadcast from the window by __shfl_sync, before it adds any of them.
// The caller (ops/cuda/spmm.py:_spmm_layout) picks S, R, U and a register
// cap.
//
// Every output entry is written exactly once, by one lane, so no atomics
// are needed and the summation order is fixed: results are bitwise
// reproducible from run to run. Rows with no edges are written as zeros.
//
// Bound on an H100: memory. Each edge costs one gathered row of D floats
// (E*D*4 bytes, ~1.1 GB at E=2M, D=128) against 2*D flops, far below the
// card's ~20 flops/byte balance point. The compulsory traffic (each input
// and output once) is far smaller than the gathered traffic, so the reuse of
// gathered rows in the 50 MB L2 decides where between the two the kernel
// lands. A 64 MB table under random senders does not fit: whole 512-byte
// rows gathered at once ran at ~4.4 TB/s, the same rows from a 16 MB slice
// at ~7.6 TB/s (chip_smoke.py --sweep, the gather-rate ceiling). Strips of
// 128 bytes (8 float4) make each pass over the rows gather from a 16 MB
// slice of the table, which the L2 holds: 0.165 ms at D = 128 where whole
// rows took 0.232 (PERF.md §6). Where even a strip's slice does not
// fit (edge rows of [E, 128], 1 GB, read once), rows stay whole.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
// order it is the backward of an endpoint gather (contiguous rows).
//
// Warp w of block column y takes rows [w * R, w * R + R), strip y. The
// first port gave each row one warp: at D = 8 a row of ~15 edges left most
// of a warp's 16 edge groups with one edge, and 16 waves of warps each
// waited on indptr, then col, then the gather, then the shuffle tree; at
// D = 128 its warps gathered whole rows from all of a 64 MB table at once.
// Here R rows share a warp, the loop bounds are the longest of its rows
// (warp-uniform, so the shuffles see every lane), and what lies past a
// row's end is masked to weight 0 and never loaded. A group adds its edges
// in CSR order, the groups then by a fixed shuffle tree.
//
// A hub holds the warp's other rows to its length, on 32 / R lanes. So a
// warp first counts the index windows each way: side by side, its longest
// row's windows of 32 / R; one row after another on all 32 lanes, the sum
// of each row's windows of 32. It takes the way with fewer (side by side on
// a tie). The choice depends on the warp's rows alone, so the sums keep
// their order from run to run.
template <typename V, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
spmm_csr_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                const int* __restrict__ eid, const float* __restrict__ w,
                const V* __restrict__ x, V* __restrict__ y, int n_rows,
                int dv, int log_g, int log_rows) {
  // blockIdx.y is the strip: no division on the way to the first load
  const int rb = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (rb >= ((n_rows + (1 << log_rows) - 1) >> log_rows)) return;
  const int lane = threadIdx.x & 31;   // (warp-uniform exit above)
  const int g = 1 << log_g;                 // lanes per edge group
  const int f = blockIdx.y * g + (lane & (g - 1));
  // Sums row `row` (starting at `beg`, `len` edges) on the lanes of its
  // segment of 2^log_seg lanes; `longest` is the longest row of the warp's
  // segments (warp-uniform).
  auto walk = [&](int row, int beg, int len, int longest, int log_seg) {
    const int seg = 1 << log_seg;             // lanes per row
    const int first = lane & ~(seg - 1);      // the row's first lane
    const int sl = lane & (seg - 1);          // lane within the row
    const int p = seg >> log_g;               // edge groups per row
    const int grp = sl >> log_g;
    const bool active = row < n_rows && f < dv;
    // lane sl of the row holds window position w0 + sl: its source row
    // and weight, 0 past the row's end
    auto fetch = [&](int w0, int& c, float& wt) {
      c = 0;
      wt = 0.f;
      if (w0 + sl < len) {
        const int k = beg + w0 + sl;
        c = col ? col[k] : k;
        wt = w ? w[eid ? eid[k] : k] : 1.f;
      }
    };
    int c, nc;
    float wt, nwt;
    fetch(0, c, wt);
    V acc = vzero<V>();
    for (int w0 = 0; w0 < longest; w0 += seg) {   // warp-uniform trips
      fetch(w0 + seg, nc, nwt);                   // the next window, ahead
      const int cnt = min(seg, longest - w0);
      for (int j0 = 0; j0 < cnt; j0 += p * U) {   // warp-uniform trips
        V v[U];
        float wj[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * p + grp;
          const int src = first + (j & (seg - 1));
          const int cj = __shfl_sync(kFull, c, src);
          wj[u] = __shfl_sync(kFull, wt, src);
          const bool ok = active && j < seg && w0 + j < len;
          if (!ok) wj[u] = 0.f;
          v[u] = ok ? x[(long long)cj * dv + f] : vzero<V>();
        }
#pragma unroll
        for (int u = 0; u < U; ++u) axpy(acc, wj[u], v[u]);
      }
      c = nc;
      wt = nwt;
    }
    // the groups' lanes of one column are G apart, within the row's lanes
    for (int off = g; off < seg; off <<= 1) add_xor(acc, off);
    if (active && grp == 0) y[(long long)row * dv + f] = acc;
  };
  const int log_seg = 5 - log_rows;
  const int row = (rb << log_rows) + (lane >> log_seg);
  const int beg = row < n_rows ? indptr[row] : 0;
  const int len = row < n_rows ? indptr[row + 1] - beg : 0;
  const int longest = __reduce_max_sync(kFull, len);
  const int alone = __reduce_add_sync(
      kFull, (lane & ((1 << log_seg) - 1)) == 0 ? (len + 31) >> 5 : 0);
  if (alone < (longest + (1 << log_seg) - 1) >> log_seg) {
    for (int i = 0; i < 1 << log_rows; ++i) {   // one row after another
      const int li = __shfl_sync(kFull, len, i << log_seg);
      walk((rb << log_rows) + i, __shfl_sync(kFull, beg, i << log_seg), li,
           li, 5);
    }
  } else {
    walk(row, beg, len, longest, log_seg);
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

// K1. Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without launching when vec4 is set but d % 4 != 0
// or x, y are not 16-byte aligned, when log_strip is negative or wider
// than the row's G, when R rows of a strip do not fit in a warp (log_strip
// + log_rows > 5), or when the library holds no instance of (unroll,
// reg_cap). It holds the two that ops/cuda/spmm.py:_spmm_layout picks, (2,
// 0) and (8, 64); built with GNN_SWEEP (the build chip_smoke.py --sweep
// times) it holds unroll 1, 2, 4 and 8 each with reg_cap 0 and 64. The
// caller allocates y [n_rows, d] and makes sure n_rows > 0, d > 0, that
// the strips fit the grid's second dimension (fewer than 2^16) and n_rows
// < 2^31 - 32. vec4: load rows as float4; log_rows: log2 of the rows per
// warp; log_strip: log2 of the vectors of a strip, the lanes of an edge
// group; unroll: the gathers an edge group issues before it adds them;
// reg_cap: registers per thread (0: none; 64: 4 blocks of 8 warps per SM).
int spmm_csr_f32(const int* indptr, const int* col, const int* eid,
                 const float* w, const float* x, float* y, int n_rows, int d,
                 int vec4, int log_rows, int log_strip, int unroll,
                 int reg_cap, void* stream) {
  if (vec4 && (d % 4 != 0 || !aligned16(x) || !aligned16(y)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dv = vec4 ? d / 4 : d;
  const int lg = log_strip;
  if (log_rows < 0 || lg < 0 || lg > log_group(dv) || lg + log_rows > 5)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_blocks = (n_rows + (1 << log_rows) - 1) >> log_rows;
  const dim3 blocks((row_blocks + kWarpsPerBlock - 1) / kWarpsPerBlock,
                    (dv + (1 << lg) - 1) >> lg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool launched = false;
  auto go = [&](auto vec, auto un, auto minb) {
    using V = decltype(vec);
    constexpr int U = decltype(un)::value, MINB = decltype(minb)::value;
    spmm_csr_kernel<V, U, MINB><<<blocks, kThreads, 0, s>>>(
        indptr, col, eid, w, reinterpret_cast<const V*>(x),
        reinterpret_cast<V*>(y), n_rows, dv, lg, log_rows);
    launched = true;
  };
  using I1 = std::integral_constant<int, 1>;
  using I4 = std::integral_constant<int, 4>;
  auto with_unroll = [&](auto vec) {
#ifndef GNN_SWEEP
    if (unroll == 2 && reg_cap == 0)
      go(vec, std::integral_constant<int, 2>{}, I1{});
    if (unroll == 8 && reg_cap == 64)
      go(vec, std::integral_constant<int, 8>{}, I4{});
#else
    auto pick = [&](auto un) {   // U = un, with no cap or at 64 registers
      if (unroll != decltype(un)::value) return;
      if (reg_cap == 0) go(vec, un, I1{});
      if (reg_cap == 64) go(vec, un, I4{});
    };
    pick(I1{});
    pick(std::integral_constant<int, 2>{});
    pick(I4{});
    pick(std::integral_constant<int, 8>{});
#endif
  };
  if (vec4)
    with_unroll(float4{});
  else
    with_unroll(float{});
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
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
