// CSR sparse x dense products for message passing: K1 (SpMM) and K2 (the
// fused weighted-SpMM backward), float32, for sm_90a.
//
// Both kernels walk a compressed-sparse-row edge grouping:
//   indptr int32[n_rows + 1]   edges of row i are positions [indptr[i], indptr[i+1])
//   col    int32[E]            the row of the dense operand each position reads
//   eid    int32[E] or NULL    the original edge id of each position (NULL: identity)
//   w      float[E] or NULL    per-edge weights, indexed by original edge id
//                              (K2: float[E, H], one per edge and head)
//
// A row's D floats are split into vectors (float4 when D % 4 == 0 and the
// pointers are 16-byte aligned, else single floats), and G lanes (the vector
// count rounded up to a power of two, at most 32) cover a row's width, or a
// chunk of 32 vectors of a wider row.
//
// The layout of both kernels (see spmm_csr_kernel): a row's vectors split
// into strips of S = 2^log_strip vectors (at most G), one strip per block
// column, so the grid runs strip after strip over all rows; a warp takes R =
// 2^log_rows consecutive rows of one strip, each row owning 32 / R lanes,
// which split into edge groups of S lanes. The row's lanes load a window of
// 32 / R edge indices (and weights) at once, one per lane, and load the next
// window's while the current one's rows are gathered; each group issues U
// gathers, broadcast from the window by __shfl_sync, before it adds any of
// them. The caller (ops/cuda/spmm.py:_spmm_layout, _spmm_sddmm_layout) picks
// S, R, U and a register cap.
//
// K2 takes H heads of D floats a row ([rows, H, D]), heads in the grid's
// second dimension ahead of the strips (block column h * strips + strip), so
// the resident warps gather one head's strip of dy. Each edge group holds
// its row's x strip in registers; each gathered dy strip feeds both the dx
// sum and the strip's share of the dot <dy[r], x[s]>, which the group's S
// lanes reduce (U dots by halving, see spmm_sddmm_csr_kernel); each lane
// then takes one position's dot, so that a row's lanes store a window of
// dots at once. The weights and the dots live in edge-id order ([E, H]),
// which the sender CSR visits at random. Read and written there by each
// head's pass, a 4-byte access per edge to another 32-byte sector, w and dw
// ([E, 4], 32 MB each at GAT's H=4) crowd the head's 16 MB slice of dy out
// of the L2 (0.91 ms against 0.43, PERF.md §6). So with several heads K2
// reads its weights and writes its dots by sender-CSR position
// (by_position): a pass before the sweep gathers w into [H, E] in that
// order, the sweep stores each strip's share of each dot to [H, strips, E]
// scratch, and a pass after it adds an edge's shares in strip order and
// writes its H dots to dw[eid] at once. One head reads w[eid] in the sweep
// and writes each dot to dw[eid] there, or, over several strips, its
// shares to the scratch and the pass after adds them. Strips run as
// separate block columns in no fixed order, so no strip adds to another's
// dw.
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

// The first warp of a row-walking kernel's block, or -1 past the rows
// (blockIdx.y is a strip, or a head and strip: no division on the way to
// the first load).
__device__ __forceinline__ int row_block(int n_rows, int log_rows) {
  const int rb = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  return rb < ((n_rows + (1 << log_rows) - 1) >> log_rows) ? rb : -1;
}

// Calls walk(row, beg, len, longest, log_seg) for the R = 2^log_rows rows
// of warp rb side by side, row i on the 2^log_seg = 32 / R lanes from
// i * 32 / R (len: the row's edges from beg; longest: the longest of the
// warp's rows, warp-uniform), or once for each row on all 32 lanes
// (log_seg = 5), one after another.
//
// A hub holds the warp's other rows to its length, on 32 / R lanes. So a
// warp first counts the index windows each way: side by side, its longest
// row's windows of 32 / R; one row after another on all 32 lanes, the sum
// of each row's windows of 32. It takes the way with fewer (side by side on
// a tie). The choice depends on the warp's rows alone, so the sums keep
// their order from run to run.
template <typename Walk>
__device__ __forceinline__ void walk_rows(const int* __restrict__ indptr,
                                          int rb, int lane, int n_rows,
                                          int log_rows, Walk&& walk) {
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
// in CSR order, the groups then by a fixed shuffle tree; a hub switches the
// warp to one row after another (walk_rows).
template <typename V, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
spmm_csr_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                const int* __restrict__ eid, const float* __restrict__ w,
                const V* __restrict__ x, V* __restrict__ y, int n_rows,
                int dv, int log_g, int log_rows) {
  const int rb = row_block(n_rows, log_rows);
  if (rb < 0) return;                  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;                 // lanes per edge group
  const int f = blockIdx.y * g + (lane & (g - 1));
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
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
  });
}

// K2, replacing graphneuralnetworks_tpu/ops/pallas/spmm.py:
// _scatter_sddmm_kernel. Over the sender CSR (row s = a source node), head
// h:
//   dx[s, h]      = sum_{k in row s} w[eid[k], h] * dy[col[k], h]
//   dw[eid[k], h] = <dy[col[k], h], x[s, h]>          (unweighted)
// in one sweep on K1's walk, block column y = h * n_strips + strip. The
// weight of position k is w[id * w_row + h * w_head], id = eid[k] (k where
// eid is NULL). Each group's dots of a window are handed by shuffles to the
// lane that holds the window's position, so that the row's lanes store the
// window's dots at once: part == NULL (a head is one strip, edge-id order)
// to dw[id, h]; else the strip's share to part[y, k], k the sender-CSR
// position, one run of the row's positions. The first port gave a row one
// warp, whole rows from all of the table, and waited on each edge's gather,
// then its 5-step dot tree, then its dw write, one edge at a time.
template <typename V, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
spmm_sddmm_csr_kernel(const int* __restrict__ indptr,
                      const int* __restrict__ col,
                      const int* __restrict__ eid,
                      const float* __restrict__ w,
                      const V* __restrict__ dy, const V* __restrict__ x,
                      V* __restrict__ dx, float* __restrict__ dw,
                      float* __restrict__ part, int n_rows, int heads,
                      int dv, int n_strips, long long n_edges,
                      long long w_row, long long w_head, int log_g,
                      int log_rows) {
  const int rb = row_block(n_rows, log_rows);
  if (rb < 0) return;                  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;                 // lanes per edge group
  const int sub = lane & (g - 1);
  const int h = blockIdx.y / n_strips;
  const int f = (blockIdx.y - h * n_strips) * g + sub;
  const bool on = f < dv;
  float* out = part ? part + (long long)blockIdx.y * n_edges : nullptr;
  const float* wh = w ? w + h * w_head : nullptr;
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const int seg = 1 << log_seg;             // lanes per row
    const int first = lane & ~(seg - 1);      // the row's first lane
    const int sl = lane & (seg - 1);          // lane within the row
    const int p = seg >> log_g;               // edge groups per row
    const int grp = sl >> log_g;
    const bool live = row < n_rows;
    // x, the dots, dx and the weights in CSR order stream past the L2
    // (evict-first), which keeps the slice of dy that the pass gathers from
    const V xs = live && on ? __ldcs(x + ((long long)row * heads + h) * dv + f)
                            : vzero<V>();
    // lane sl of the row holds window position w0 + sl: its source row,
    // edge id and weight
    auto fetch = [&](int w0, int& c, int& id, float& wt) {
      c = 0;
      id = 0;
      wt = 0.f;
      if (w0 + sl < len) {
        const int k = beg + w0 + sl;
        c = col[k];
        id = eid ? eid[k] : k;
        // weights in CSR order stream; by edge id a sector serves 8 edges
        wt = !wh ? 1.f : eid ? wh[id * w_row] : __ldcs(wh + k * w_row);
      }
    };
    int c, id, nc, nid;
    float wt, nwt;
    fetch(0, c, id, wt);
    V acc = vzero<V>();
    for (int w0 = 0; w0 < longest; w0 += seg) {   // warp-uniform trips
      fetch(w0 + seg, nc, nid, nwt);              // the next window, ahead
      const int cnt = min(seg, longest - w0);
      float mine = 0.f;   // the dot of window position w0 + sl
      for (int j0 = 0; j0 < cnt; j0 += p * U) {   // warp-uniform trips
        V v[U];
        float wj[U], dt[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {   // the gathers of U edges first
          const int j = j0 + u * p + grp;
          const int src = first + (j & (seg - 1));
          const int cj = __shfl_sync(kFull, c, src);
          wj[u] = __shfl_sync(kFull, wt, src);
          const bool ok = live && j < seg && w0 + j < len;
          if (!ok) wj[u] = 0.f;
          v[u] = ok && on ? dy[((long long)cj * heads + h) * dv + f]
                          : vzero<V>();
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          axpy(acc, wj[u], v[u]);
          dt[u] = vdot(v[u], xs);
        }
        // Position j0 + u * p + q is group q's edge u; its dot goes to
        // lane j0 + u * p + q of the row.
        if (U <= g) {   // warp-uniform
          // The group's S lanes add the U dots by halving: at offset S/2
          // a lane keeps the U/2 dots of its half, adds its partner's
          // shares of them and hands over the other half, and so on, U - 1
          // shuffles for U dots (a tree for each would take U log2 S); then
          // a tree over the lanes left. Lane sub of the group ends with the
          // dot of edge sub >> log2(S / U).
          int off = g;
#pragma unroll
          for (int n = U / 2; n >= 1; n /= 2) {
            off >>= 1;
            const bool upper = (sub & off) != 0;
#pragma unroll
            for (int i = 0; i < n; ++i) {
              const float keep = upper ? dt[i + n] : dt[i];
              const float give = upper ? dt[i] : dt[i + n];
              dt[i] = keep + __shfl_xor_sync(kFull, give, off);
            }
          }
          for (off >>= 1; off >= 1; off >>= 1)
            dt[0] += __shfl_xor_sync(kFull, dt[0], off);
          const int r = sl - j0;   // this lane's position in the batch
          const int u = r >> (log_seg - log_g);
          const float t = __shfl_sync(
              kFull, dt[0],
              first + ((r & (p - 1)) << log_g) + u * (g / U));
          if (r >= 0 && r < p * U) mine = t;
        } else {
          for (int off = 1; off < g; off <<= 1) {   // the group's S lanes
#pragma unroll
            for (int u = 0; u < U; ++u)
              dt[u] += __shfl_xor_sync(kFull, dt[u], off);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int q = sl - j0 - u * p;
            const float t = __shfl_sync(kFull, dt[u],
                                        first + ((q & (p - 1)) << log_g));
            if (q >= 0 && q < p) mine = t;
          }
        }
      }
      if (live && w0 + sl < len) {
        if (out)
          __stcs(out + beg + w0 + sl, mine);
        else
          dw[(long long)id * heads + h] = mine;
      }
      c = nc;
      id = nid;
      wt = nwt;
    }
    // the groups' lanes of one column are G apart, within the row's lanes
    for (int off = g; off < seg; off <<= 1) add_xor(acc, off);
    if (live && on && grp == 0)
      __stcs(dx + ((long long)row * heads + h) * dv + f, acc);
  });
}

// K2's passes around the sweep in sender-CSR position order, one thread a
// position k, id = eid[k] (k where eid is NULL), all H heads of an edge in
// one thread so that its H floats of w and dw [E, H] are one run (float4
// loads and stores where vec: H % 4 == 0 and the rows 16-byte aligned).
// Before: wk[h, k] = w[id, h], the
// weights in the order the sweep reads them. After: dw[id, h] = the sum of
// part[h * n_strips + j, k] over the strips j in order.
__global__ void __launch_bounds__(kThreads)
spmm_sddmm_weights_kernel(const int* __restrict__ eid,
                          const float* __restrict__ w,
                          float* __restrict__ wk, long long n_edges,
                          int heads, bool vec) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n_edges) return;
  const float* src = w + (long long)(eid ? eid[k] : k) * heads;
  if (vec) {
    for (int h = 0; h < heads; h += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + h);
      wk[h * n_edges + k] = v.x;
      wk[(h + 1) * n_edges + k] = v.y;
      wk[(h + 2) * n_edges + k] = v.z;
      wk[(h + 3) * n_edges + k] = v.w;
    }
  } else {
    for (int h = 0; h < heads; ++h) wk[h * n_edges + k] = src[h];
  }
}

__global__ void __launch_bounds__(kThreads)
spmm_sddmm_sum_kernel(const int* __restrict__ eid,
                      const float* __restrict__ part, float* __restrict__ dw,
                      long long n_edges, int heads, int n_strips,
                      bool vec) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n_edges) return;
  float* dst = dw + (long long)(eid ? eid[k] : k) * heads;
  auto strip_sum = [&](int h) {
    const float* ph = part + (long long)h * n_strips * n_edges + k;
    float t = 0.f;
    for (int j = 0; j < n_strips; ++j) t += ph[(long long)j * n_edges];
    return t;
  };
  if (vec) {
    for (int h = 0; h < heads; h += 4)
      *reinterpret_cast<float4*>(dst + h) = make_float4(
          strip_sum(h), strip_sum(h + 1), strip_sum(h + 2), strip_sum(h + 3));
  } else {
    for (int h = 0; h < heads; ++h) dst[h] = strip_sum(h);
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

// Whether a strip of 2^log_strip vectors fits rows of dv vectors (at most
// the row's G) and R = 2^log_rows rows of it fit in a warp.
bool layout_ok(int dv, int log_rows, int log_strip) {
  return log_rows >= 0 && log_strip >= 0 && log_strip <= log_group(dv) &&
         log_strip + log_rows <= 5;
}

// The grid of a row walk: blocks of 8 warps of 2^log_rows rows each, by
// `columns` (strips, or heads times strips).
dim3 row_grid(int n_rows, int log_rows, int columns) {
  const int row_blocks = (n_rows + (1 << log_rows) - 1) >> log_rows;
  return dim3((row_blocks + kWarpsPerBlock - 1) / kWarpsPerBlock, columns);
}

using I0 = std::integral_constant<int, 0>;
using I1 = std::integral_constant<int, 1>;
using I2 = std::integral_constant<int, 2>;
using I4 = std::integral_constant<int, 4>;
using I8 = std::integral_constant<int, 8>;
using I64 = std::integral_constant<int, 64>;

// Blocks per SM a register cap asks of __launch_bounds__: 64 registers a
// thread is 4 blocks of 8 warps.
template <int CAP>
using MinBlocks = std::integral_constant<int, CAP == 64 ? 4 : 1>;

// Calls go(un, minb) for the instance of U = unroll gathers in flight at
// reg_cap registers (0: none; 64) where the library holds it, and returns
// whether it did. Built with GNN_SWEEP (the build chip_smoke.py --sweep
// times) the library holds U in {1, 2, 4, 8}, each uncapped and at 64
// registers; the shipped library only the pairs for which Pick::holds(U,
// cap), the ones ops/cuda/spmm.py picks.
template <typename Pick, typename Go>
bool with_instances(int unroll, int reg_cap, Go&& go) {
  bool launched = false;
  auto pick = [&](auto un, auto cap) {
    constexpr int UU = decltype(un)::value, C = decltype(cap)::value;
#ifdef GNN_SWEEP
    constexpr bool built = true;
#else
    constexpr bool built = Pick::holds(UU, C);
#endif
    if constexpr (built) {
      if (unroll == UU && reg_cap == C) {
        go(un, MinBlocks<C>{});
        launched = true;
      }
    }
  };
  pick(I1{}, I0{});
  pick(I1{}, I64{});
  pick(I2{}, I0{});
  pick(I2{}, I64{});
  pick(I4{}, I0{});
  pick(I4{}, I64{});
  pick(I8{}, I0{});
  pick(I8{}, I64{});
  return launched;
}

// The shipped instances, from chip_smoke.py --sweep (PERF.md §6), as
// ops/cuda/spmm.py's _K1_* and _K2_* constants pick them: edge groups
// narrower than a 128-byte line 2 gathers in flight uncapped, groups of a
// line or more 8 (K1) or 4 (K2) at 64 registers.
struct K1Pick {
  static constexpr bool holds(int u, int cap) {
    return (u == 2 && cap == 0) || (u == 8 && cap == 64);
  }
};
struct K2Pick {
  static constexpr bool holds(int u, int cap) {
    return (u == 2 && cap == 0) || (u == 4 && cap == 64);
  }
};

}  // namespace

extern "C" {

// K1. Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without launching when vec4 is set but d % 4 != 0
// or x, y are not 16-byte aligned, when log_strip is negative or wider
// than the row's G, when R rows of a strip do not fit in a warp (log_strip
// + log_rows > 5), or when the library holds no instance of (unroll,
// reg_cap) (see with_instances and K1Pick). The caller allocates y
// [n_rows, d] and makes sure n_rows > 0, d > 0, that the strips fit the
// grid's second dimension (fewer than 2^16) and n_rows < 2^31 - 32. vec4:
// load rows as float4; log_rows: log2 of the rows per warp; log_strip: log2
// of the vectors of a strip, the lanes of an edge group; unroll: the
// gathers an edge group issues before it adds them; reg_cap: registers per
// thread (0: none; 64: 4 blocks of 8 warps per SM).
int spmm_csr_f32(const int* indptr, const int* col, const int* eid,
                 const float* w, const float* x, float* y, int n_rows, int d,
                 int vec4, int log_rows, int log_strip, int unroll,
                 int reg_cap, void* stream) {
  if (vec4 && (d % 4 != 0 || !aligned16(x) || !aligned16(y)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dv = vec4 ? d / 4 : d;
  if (!layout_ok(dv, log_rows, log_strip))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = row_grid(n_rows, log_rows,
                             (dv + (1 << log_strip) - 1) >> log_strip);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto vec) {
    using V = decltype(vec);
    return with_instances<K1Pick>(unroll, reg_cap, [&](auto un, auto minb) {
      spmm_csr_kernel<V, decltype(un)::value, decltype(minb)::value>
          <<<grid, kThreads, 0, s>>>(indptr, col, eid, w,
                                     reinterpret_cast<const V*>(x),
                                     reinterpret_cast<V*>(y), n_rows, dv,
                                     log_strip, log_rows);
    });
  };
  if (!(vec4 ? launch(float4{}) : launch(float{})))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K2. Over the sender CSR of n_rows senders and n_edges edges: dy
// [n_dy, H, d] (the receivers'), x [n_rows, H, d], w [n_edges, H] by edge
// id (NULL: unweighted); dx [n_rows, H, d] and dw [n_edges, H], every entry
// of both written. vec4, log_rows, log_strip, unroll and reg_cap as K1's
// (see with_instances and K2Pick for the instances built). by_position: the
// sweep reads the weights and writes the dots in sender-CSR order, head
// after head, and two passes around it move them from and to edge-id order
// (spmm_sddmm_weights_kernel, spmm_sddmm_sum_kernel); scratch is then H *
// (strips + 1) * n_edges floats (H * strips * n_edges without w). Else the
// sweep reads w[eid[k], h] and writes dw[eid[k], h] itself, and needs H *
// strips * n_edges floats of scratch only where a head spans more than one
// strip of 2^log_strip vectors. Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue with nothing launched for what K1
// refuses, for H * strips of 2^16 or more, or for a missing scratch. The
// caller makes sure n_rows > 0, H > 0, d > 0 and n_edges < 2^31.
int spmm_sddmm_csr_f32(const int* indptr, const int* col, const int* eid,
                       const float* w, const float* dy, const float* x,
                       float* dx, float* dw, float* scratch, int n_rows,
                       int heads, int d, int n_edges, int vec4, int log_rows,
                       int log_strip, int unroll, int reg_cap,
                       int by_position, void* stream) {
  if (vec4 && (d % 4 != 0 || !aligned16(dy) || !aligned16(x) ||
               !aligned16(dx)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dv = vec4 ? d / 4 : d;
  if (!layout_ok(dv, log_rows, log_strip))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_strips = (dv + (1 << log_strip) - 1) >> log_strip;
  const bool part_needed = by_position || n_strips > 1;
  if (heads <= 0 || (long long)heads * n_strips >= 65536 ||
      (part_needed && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part = part_needed ? scratch : nullptr;
  // by position: the weights in sender-CSR order, head after head, in wk
  float* wk = by_position && w != nullptr
                  ? scratch + (long long)heads * n_strips * n_edges
                  : nullptr;
  const dim3 edge_grid((n_edges + kThreads - 1) / kThreads);
  const dim3 grid = row_grid(n_rows, log_rows, heads * n_strips);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto vec) {
    using V = decltype(vec);
    return with_instances<K2Pick>(unroll, reg_cap, [&](auto un, auto minb) {
      if (wk != nullptr && n_edges > 0)
        spmm_sddmm_weights_kernel<<<edge_grid, kThreads, 0, s>>>(
            eid, w, wk, n_edges, heads, heads % 4 == 0 && aligned16(w));
      spmm_sddmm_csr_kernel<V, decltype(un)::value, decltype(minb)::value>
          <<<grid, kThreads, 0, s>>>(
              indptr, col, by_position ? nullptr : eid,
              by_position ? wk : w, reinterpret_cast<const V*>(dy),
              reinterpret_cast<const V*>(x), reinterpret_cast<V*>(dx), dw,
              part, n_rows, heads, dv, n_strips, n_edges,
              by_position ? 1LL : heads, by_position ? n_edges : 1LL,
              log_strip, log_rows);
    });
  };
  if (!(vec4 ? launch(float4{}) : launch(float{})))
    return static_cast<int>(cudaErrorInvalidValue);
  if (part != nullptr && n_edges > 0)
    spmm_sddmm_sum_kernel<<<edge_grid, kThreads, 0, s>>>(
        eid, part, dw, n_edges, heads, n_strips,
        heads % 4 == 0 && aligned16(dw));
  return static_cast<int>(cudaGetLastError());
}

const char* gnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
