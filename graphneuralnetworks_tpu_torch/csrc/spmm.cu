// CSR sparse x dense products for message passing: K1 (SpMM) and K2 (the
// fused weighted-SpMM backward), float32 and bfloat16 (vec.cuh), for
// sm_90a.
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
// dw. bfloat16 rows of 4 heads that together fit one group of lanes take
// the all-heads walk instead (spmm_sddmm_heads_kernel): one group gathers
// every head of dy[r] at once and reads and writes an edge's 4 weights and
// dots by edge id in one access each, with no scratch and no passes.
//
// Every output entry is written exactly once, by one lane, so no atomics
// are needed and the summation order is fixed: results are bitwise
// reproducible from run to run. Rows with no edges are written as zeros.
//
// bfloat16 (spmm_csr_bf16, spmm_sddmm_csr_bf16): rows, weights and outputs
// are bfloat16, loaded as bf16x8, bf16x4 or bf16x1 (vec.cuh) and widened
// to float where they are used; every sum (y, dx, each dot and each
// strip's share of it) is float32, and y, dx and dw are rounded once when
// stored. K2's scratch of dots by position stays float32; its weights in
// sender-CSR order are a copy of the bfloat16 ones.
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
// fit (edge rows of [E, 128], 1 GB, read once), rows stay whole. bfloat16
// K1 takes a layout of its own (ops/cuda/spmm.py:_spmm_bf16_layout): a
// bf16x8 row of at most 256 bytes is one whole-row strip at any table
// size, so col, eid, w and the walk are read once, and a row of one
// vector takes spmm_csr_lanes_kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "vec.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

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
//
// V is the rows' storage vector (vec.cuh): float4 or float, or for
// bfloat16 rows bf16x8, bf16x4 or bf16x1, whose weights are bfloat16 too.
// The gathers load V, and each is widened to float where it is added, so
// that the sum is float32 and y is rounded once when stored.
template <typename V, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
spmm_csr_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                const int* __restrict__ eid,
                const Scalar<V>* __restrict__ w, const V* __restrict__ x,
                V* __restrict__ y, int n_rows, int dv, int log_g,
                int log_rows) {
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
        wt = w ? ldf(w + (eid ? eid[k] : k)) : 1.f;
      }
    };
    int c, nc;
    float wt, nwt;
    fetch(0, c, wt);
    Acc<V> acc = vzero<Acc<V>>();
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
        for (int u = 0; u < U; ++u) axpy(acc, wj[u], widen(v[u]));
      }
      c = nc;
      wt = nwt;
    }
    // the groups' lanes of one column are G apart, within the row's lanes
    for (int off = g; off < seg; off <<= 1) add_xor(acc, off);
    if (active && grp == 0) y[(long long)row * dv + f] = narrow<V>(acc);
  });
}

// K1 on rows of one vector (bf16x8 rows of D = 8 values, 16 bytes): each
// lane an edge group that takes whole edges. spmm_csr_kernel's groups of
// one lane take one edge a window, one window ahead: its U edges of a
// window fall past the window's 32 / R positions, so at D = 8 it gathered
// one 16-byte row at a time a lane (0.0239 ms against float32's 0.0201 on
// twice the bytes, PERF.md §6). Here lane sl of a row's 32 / R lanes takes
// positions sl, sl + 32 / R, ... in batches of U: it loads a batch's
// indices (and weights) itself, one batch ahead, issues the batch's U
// gathers before it adds any, and adds its edges in CSR order; the row's
// lanes then merge by spmm_csr_kernel's tree (the same sums in the same
// order as spmm_csr_kernel at groups of one lane). No shuffle in the walk,
// so a lane's trips are its own; the hub switch (walk_rows) as K1's.
template <typename V, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
spmm_csr_lanes_kernel(const int* __restrict__ indptr,
                      const int* __restrict__ col,
                      const int* __restrict__ eid,
                      const Scalar<V>* __restrict__ w,
                      const V* __restrict__ x, V* __restrict__ y,
                      int n_rows, int log_rows) {
  const int rb = row_block(n_rows, log_rows);
  if (rb < 0) return;                  // warp-uniform
  const int lane = threadIdx.x & 31;
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int, int log_seg) {
    const int seg = 1 << log_seg;             // lanes per row
    const int sl = lane & (seg - 1);          // lane within the row
    // this lane's edges j0 + u * seg + sl of a batch: source rows and
    // weights, 0 past the row's end
    auto fetch = [&](int j0, int (&c)[U], float (&wt)[U]) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * seg + sl;
        c[u] = 0;
        wt[u] = 0.f;
        if (j < len) {
          const int k = beg + j;
          c[u] = col ? col[k] : k;
          wt[u] = w ? ldf(w + (eid ? eid[k] : k)) : 1.f;
        }
      }
    };
    int c[U], nc[U];
    float wt[U], nwt[U];
    fetch(0, c, wt);
    Acc<V> acc = vzero<Acc<V>>();
    for (int j0 = 0; j0 < len; j0 += seg * U) {
      fetch(j0 + seg * U, nc, nwt);              // the next batch, ahead
      V v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u] = j0 + u * seg + sl < len ? x[c[u]] : vzero<V>();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        axpy(acc, wt[u], widen(v[u]));
        c[u] = nc[u];
        wt[u] = nwt[u];
      }
    }
    for (int off = 1; off < seg; off <<= 1) add_xor(acc, off);
    if (row < n_rows && sl == 0) y[row] = narrow<V>(acc);
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
//
// V is the rows' storage vector as K1's: bfloat16 rows take bfloat16
// weights and dots, with float32 sums and part.
template <typename V, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
spmm_sddmm_csr_kernel(const int* __restrict__ indptr,
                      const int* __restrict__ col,
                      const int* __restrict__ eid,
                      const Scalar<V>* __restrict__ w,
                      const V* __restrict__ dy, const V* __restrict__ x,
                      V* __restrict__ dx, Scalar<V>* __restrict__ dw,
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
  const Scalar<V>* wh = w ? w + h * w_head : nullptr;
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
    const Acc<V> xs =
        live && on ? widen(ld_cs(x + ((long long)row * heads + h) * dv + f))
                   : vzero<Acc<V>>();
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
        wt = !wh    ? 1.f
             : eid  ? ldf(wh + id * w_row)
                    : widen(ld_cs(wh + k * w_row));
      }
    };
    int c, id, nc, nid;
    float wt, nwt;
    fetch(0, c, id, wt);
    Acc<V> acc = vzero<Acc<V>>();
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
          const Acc<V> vu = widen(v[u]);
          axpy(acc, wj[u], vu);
          dt[u] = vdot(vu, xs);
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
          stf(dw + (long long)id * heads + h, mine);
      }
      c = nc;
      id = nid;
      wt = nwt;
    }
    // the groups' lanes of one column are G apart, within the row's lanes
    for (int off = g; off < seg; off <<= 1) add_xor(acc, off);
    if (live && on && grp == 0)
      st_cs(dx + ((long long)row * heads + h) * dv + f, narrow<V>(acc));
  });
}

// K2 on bfloat16 rows, the four heads of a sender row in one edge group
// (the all-heads walk, mode 2 of launch_spmm_sddmm): the function of
// spmm_sddmm_csr_kernel at H = 4 heads of hv = 2^log_hv bf16x8 vectors,
// where the heads' rows together are one gathered row of G = 4 * hv
// vectors (at most 256 bytes: GAT (b)'s H = 4, D = 32 is 16 lanes of 16
// bytes). Lane sub of a group holds vector sub of the [4, D] row, head
// sub / hv. With the heads in the grid (spmm_sddmm_csr_kernel) each head's
// pass reads its weight and writes its dot by edge id, a 2-byte access to
// another 32-byte sector per edge, or goes through [H, E] float32 scratch
// by sender-CSR position with a pass before and one after (by_position).
// Here an edge's 4 weights are one 8-byte load by edge id, made by the
// lane that holds its window position, one window ahead, and handed to the
// group's lanes by two shuffles; the group's lanes of a head add its dot
// (log2 hv shuffles), and two shuffles pack the four rounded dots into
// the group's first lane, which stores them to dw[id, :] in one 8-byte
// store. dy[r] is gathered once for all heads; no scratch, no pass before
// or after. Every sum is float32 in a fixed order; dx and each dot are
// rounded once. Four heads only: at 2 and 8 heads the instance of 4
// gathers in flight at 64 registers spilled (PERF.md §6).
template <typename V, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
spmm_sddmm_heads_kernel(const int* __restrict__ indptr,
                        const int* __restrict__ col,
                        const int* __restrict__ eid,
                        const bf16x1* __restrict__ w,
                        const V* __restrict__ dy, const V* __restrict__ x,
                        V* __restrict__ dx, bf16x1* __restrict__ dw,
                        int n_rows, int log_hv, int log_rows) {
  constexpr unsigned kOnes = 0x3f803f80u;    // two bfloat16 1.0
  const int rb = row_block(n_rows, log_rows);
  if (rb < 0) return;                        // warp-uniform
  const int lane = threadIdx.x & 31;
  const int hv = 1 << log_hv;                // lanes of a head
  const int log_g = log_hv + 2;
  const int g = 1 << log_g;                  // lanes of an edge group
  const int sub = lane & (g - 1);
  const int head = sub >> log_hv;
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const int seg = 1 << log_seg;             // lanes per row
    const int first = lane & ~(seg - 1);      // the row's first lane
    const int sl = lane & (seg - 1);          // lane within the row
    const int p = seg >> log_g;               // edge groups per row
    const int grp = sl >> log_g;
    const bool live = row < n_rows;
    // x and dx stream past the L2 (evict-first), which keeps dy
    const Acc<V> xs = live ? widen(ld_cs(x + (long long)row * g + sub))
                           : vzero<Acc<V>>();
    // lane sl of the row holds window position w0 + sl: its source row,
    // edge id and the edge's 4 weights (heads 0, 1 in wt.x, 2, 3 in wt.y)
    auto fetch = [&](int w0, int& c, int& id, uint2& wt) {
      c = 0;
      id = 0;
      wt = make_uint2(kOnes, kOnes);
      if (w0 + sl < len) {
        const int k = beg + w0 + sl;
        c = col[k];
        id = eid ? eid[k] : k;
        if (w) wt = *reinterpret_cast<const uint2*>(w + (long long)id * 4);
      }
    };
    int c, id, nc, nid;
    uint2 wt, nwt;
    fetch(0, c, id, wt);
    Acc<V> acc = vzero<Acc<V>>();
    for (int w0 = 0; w0 < longest; w0 += seg) {   // warp-uniform trips
      fetch(w0 + seg, nc, nid, nwt);              // the next window, ahead
      const int cnt = min(seg, longest - w0);
      for (int j0 = 0; j0 < cnt; j0 += p * U) {   // warp-uniform trips
        V v[U];
        float wj[U], dt[U];
        int ej[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {   // the gathers of U edges first
          const int j = j0 + u * p + grp;
          const int src = first + (j & (seg - 1));
          const int cj = __shfl_sync(kFull, c, src);
          ej[u] = __shfl_sync(kFull, id, src);
          const unsigned lo = __shfl_sync(kFull, wt.x, src);
          const unsigned hi = __shfl_sync(kFull, wt.y, src);
          const unsigned word = head < 2 ? lo : hi;
          ok[u] = live && j < seg && w0 + j < len;
          wj[u] = ok[u] ? (head & 1 ? bf_hi(word) : bf_lo(word)) : 0.f;
          v[u] = ok[u] ? dy[(long long)cj * g + sub] : vzero<V>();
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const Acc<V> vu = widen(v[u]);
          axpy(acc, wj[u], vu);
          dt[u] = vdot(vu, xs);
        }
        for (int off = 1; off < hv; off <<= 1) {   // a head's lanes
#pragma unroll
          for (int u = 0; u < U; ++u)
            dt[u] += __shfl_xor_sync(kFull, dt[u], off);
        }
        // every lane of head h holds dot h: heads 0 and 1 pack into one
        // word, 2 and 3 into another, which the group's first lane takes
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const unsigned b = bf_bits(dt[u]);
          const unsigned pair = b | (__shfl_down_sync(kFull, b, hv) << 16);
          const unsigned upper = __shfl_down_sync(kFull, pair, 2 * hv);
          if (ok[u] && sub == 0)
            *reinterpret_cast<uint2*>(dw + (long long)ej[u] * 4) =
                make_uint2(pair, upper);
        }
      }
      c = nc;
      id = nid;
      wt = nwt;
    }
    // the groups' lanes of one column are G apart, within the row's lanes
    for (int off = g; off < seg; off <<= 1) add_xor(acc, off);
    if (live && grp == 0)
      st_cs(dx + (long long)row * g + sub, narrow<V>(acc));
  });
}

// K2's passes around the sweep in sender-CSR position order, one thread a
// position k, id = eid[k] (k where eid is NULL), all H heads of an edge in
// one thread so that its H weights of w and dw [E, H] are one run, loaded
// and stored 4 at a time where vec (H % 4 == 0 and the rows aligned to 4
// weights: a float4, or 4 bfloat16 in 8 bytes). Before: wk[h, k] = w[id,
// h], the weights in the order the sweep reads them, in their own type W.
// After: dw[id, h] = the sum of part[h * n_strips + j, k] over the strips
// j in order, in float32, stored as W (rounded once for bfloat16).
template <typename W>
__global__ void __launch_bounds__(kThreads)
spmm_sddmm_weights_kernel(const int* __restrict__ eid,
                          const W* __restrict__ w, W* __restrict__ wk,
                          long long n_edges, int heads, bool vec) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n_edges) return;
  const W* src = w + (long long)(eid ? eid[k] : k) * heads;
  if (vec) {
    for (int h = 0; h < heads; h += 4) {
      if constexpr (std::is_same<W, float>::value) {
        const float4 v = *reinterpret_cast<const float4*>(src + h);
        wk[h * n_edges + k] = v.x;
        wk[(h + 1) * n_edges + k] = v.y;
        wk[(h + 2) * n_edges + k] = v.z;
        wk[(h + 3) * n_edges + k] = v.w;
      } else {   // 4 bfloat16 in one 8-byte load, copied bit for bit
        const bf16x4 v = *reinterpret_cast<const bf16x4*>(src + h);
        wk[h * n_edges + k] = static_cast<W>(v.x & 0xffffu);
        wk[(h + 1) * n_edges + k] = static_cast<W>(v.x >> 16);
        wk[(h + 2) * n_edges + k] = static_cast<W>(v.y & 0xffffu);
        wk[(h + 3) * n_edges + k] = static_cast<W>(v.y >> 16);
      }
    }
    return;
  }
  for (int h = 0; h < heads; ++h) wk[h * n_edges + k] = src[h];
}

template <typename W>
__global__ void __launch_bounds__(kThreads)
spmm_sddmm_sum_kernel(const int* __restrict__ eid,
                      const float* __restrict__ part, W* __restrict__ dw,
                      long long n_edges, int heads, int n_strips,
                      bool vec) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n_edges) return;
  W* dst = dw + (long long)(eid ? eid[k] : k) * heads;
  auto strip_sum = [&](int h) {
    const float* ph = part + (long long)h * n_strips * n_edges + k;
    float t = 0.f;
    for (int j = 0; j < n_strips; ++j) t += ph[(long long)j * n_edges];
    return t;
  };
  if (vec) {
    for (int h = 0; h < heads; h += 4) {
      const float4 t = make_float4(strip_sum(h), strip_sum(h + 1),
                                   strip_sum(h + 2), strip_sum(h + 3));
      if constexpr (std::is_same<W, float>::value)
        *reinterpret_cast<float4*>(dst + h) = t;
      else   // one 8-byte store of 4 bfloat16, each rounded once
        *reinterpret_cast<bf16x4*>(dst + h) = narrow<bf16x4>(t);
    }
    return;
  }
  for (int h = 0; h < heads; ++h) stf(dst + h, strip_sum(h));
}

int log_group(int dv) {
  int lg = 0;
  while ((1 << lg) < dv && lg < 5) ++lg;
  return lg;
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
// bfloat16 K1's rows of one bf16x8 vector in spmm_csr_lanes_kernel, as
// ops/cuda/spmm.py's _K1_BF16 picks them (the fastest of chip_smoke.py
// --sweep bf16_k1, PERF.md §6: 2 gathers in flight a lane, uncapped); its
// whole-row strips of wider bf16x8 rows take K1Pick's 8 gathers in flight
// at 64 registers, the fastest there too.
struct K1LanePick {
  static constexpr bool holds(int u, int cap) { return u == 2 && cap == 0; }
};
// bfloat16 K2's: K2Pick's (rows of 8-byte vectors and single values take
// float32's rule) and those of ops/cuda/spmm.py's _K2_BF16 for bf16x8
// heads (the fastest of chip_smoke.py --sweep bf16_k2, PERF.md §6: one
// gather in flight at 64 registers for 16-byte rows, 4 at 64 for 256-byte
// ones); and the all-heads walk's, _K2_BF16_WALK (2 at 64: its instance
// of 4 at 64 spilled 8 bytes)
struct K2Bf16Pick {
  static constexpr bool holds(int u, int cap) {
    return K2Pick::holds(u, cap) || (u == 1 && cap == 64);
  }
};
struct K2WalkPick {
  static constexpr bool holds(int u, int cap) { return u == 2 && cap == 64; }
};
template <typename V>
using K2RowPick =
    std::conditional_t<std::is_same<Acc<V>, V>::value, K2Pick, K2Bf16Pick>;

// K1 over rows of dv vectors V (see spmm_csr_f32 for the checks): the grid
// of strips and the instance of (unroll, reg_cap), then cudaGetLastError();
// bf16x8 rows of one vector in spmm_csr_lanes_kernel.
template <typename V>
int launch_spmm_csr(const int* indptr, const int* col, const int* eid,
                    const Scalar<V>* w, const void* x, void* y, int n_rows,
                    int dv, int log_rows, int log_strip, int unroll,
                    int reg_cap, cudaStream_t s) {
  if (!layout_ok(dv, log_rows, log_strip))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = row_grid(n_rows, log_rows,
                             (dv + (1 << log_strip) - 1) >> log_strip);
  if constexpr (std::is_same<V, bf16x8>::value) {
    if (dv == 1) {
      const bool launched = with_instances<K1LanePick>(
          unroll, reg_cap, [&](auto un, auto minb) {
            spmm_csr_lanes_kernel<V, decltype(un)::value,
                                  decltype(minb)::value>
                <<<grid, kThreads, 0, s>>>(indptr, col, eid, w,
                                           static_cast<const V*>(x),
                                           static_cast<V*>(y), n_rows,
                                           log_rows);
          });
      if (!launched) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const bool launched = with_instances<K1Pick>(
      unroll, reg_cap, [&](auto un, auto minb) {
        spmm_csr_kernel<V, decltype(un)::value, decltype(minb)::value>
            <<<grid, kThreads, 0, s>>>(indptr, col, eid, w,
                                       static_cast<const V*>(x),
                                       static_cast<V*>(y), n_rows, dv,
                                       log_strip, log_rows);
      });
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K2's all-heads walk (spmm_sddmm_heads_kernel) on bf16x8 rows of 4 heads
// of dv vectors: dv a power of two, 4 * dv at most 32 vectors, log_strip
// their log2 (the group's lanes), w and dw aligned to 4 values;
// cudaErrorInvalidValue, with nothing launched, for any other.
template <typename V>
int launch_spmm_sddmm_heads(const int* indptr, const int* col,
                            const int* eid, const Scalar<V>* w,
                            const void* dy, const void* x, void* dx,
                            Scalar<V>* dw, int n_rows, int heads, int dv,
                            int log_rows, int log_strip, int unroll,
                            int reg_cap, cudaStream_t s) {
  if constexpr (!std::is_same<V, bf16x8>::value) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    auto aligned = [](const void* p) {
      return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 7) == 0;
    };
    const int lg = log_group(4 * dv);
    if (heads != 4 || (dv & (dv - 1)) != 0 || dv > 8 || log_strip != lg ||
        log_rows < 0 || log_rows + lg > 5 || !aligned(w) || !aligned(dw))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid = row_grid(n_rows, log_rows, 1);
    const bool launched = with_instances<K2WalkPick>(
        unroll, reg_cap, [&](auto un, auto minb) {
          spmm_sddmm_heads_kernel<V, decltype(un)::value,
                                  decltype(minb)::value>
              <<<grid, kThreads, 0, s>>>(
                  indptr, col, eid, w, static_cast<const V*>(dy),
                  static_cast<const V*>(x), static_cast<V*>(dx), dw, n_rows,
                  lg - 2, log_rows);
        });
    if (!launched) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
  }
}

// K2 over rows of dv vectors V with weights and dots of Scalar<V> (see
// spmm_sddmm_csr_f32 for the checks and the scratch): the passes around the
// sweep where needed, the sweep at the instance of (unroll, reg_cap), then
// cudaGetLastError(); mode 2 the all-heads walk.
template <typename V>
int launch_spmm_sddmm(const int* indptr, const int* col, const int* eid,
                      const Scalar<V>* w, const void* dy, const void* x,
                      void* dx, Scalar<V>* dw, float* scratch, int n_rows,
                      int heads, int dv, int n_edges, int log_rows,
                      int log_strip, int unroll, int reg_cap,
                      int mode, cudaStream_t s) {
  using W = Scalar<V>;
  if (mode == 2)
    return launch_spmm_sddmm_heads<V>(indptr, col, eid, w, dy, x, dx, dw,
                                      n_rows, heads, dv, log_rows, log_strip,
                                      unroll, reg_cap, s);
  if (mode != 0 && mode != 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool by_position = mode == 1;
  // the weight passes move H weights 4 at a time where each edge's run of
  // them is aligned to 4 (16 bytes of float32, 8 of bfloat16)
  auto vec4 = [&](const void* p) {
    return heads % 4 == 0 &&
           (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(W) - 1)) == 0;
  };
  if (!layout_ok(dv, log_rows, log_strip))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_strips = (dv + (1 << log_strip) - 1) >> log_strip;
  const bool part_needed = by_position || n_strips > 1;
  if (heads <= 0 || (long long)heads * n_strips >= 65536 ||
      (part_needed && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part = part_needed ? scratch : nullptr;
  // by position: the weights in sender-CSR order, head after head, in wk
  W* wk = by_position && w != nullptr
              ? reinterpret_cast<W*>(scratch +
                                     (long long)heads * n_strips * n_edges)
              : nullptr;
  const dim3 edge_grid((n_edges + kThreads - 1) / kThreads);
  const dim3 grid = row_grid(n_rows, log_rows, heads * n_strips);
  const bool launched = with_instances<K2RowPick<V>>(
      unroll, reg_cap, [&](auto un, auto minb) {
        if (wk != nullptr && n_edges > 0)
          spmm_sddmm_weights_kernel<W><<<edge_grid, kThreads, 0, s>>>(
              eid, w, wk, n_edges, heads, vec4(w));
        spmm_sddmm_csr_kernel<V, decltype(un)::value, decltype(minb)::value>
            <<<grid, kThreads, 0, s>>>(
                indptr, col, by_position ? nullptr : eid,
                by_position ? wk : w, static_cast<const V*>(dy),
                static_cast<const V*>(x), static_cast<V*>(dx), dw, part,
                n_rows, heads, dv, n_strips, n_edges,
                by_position ? 1LL : heads, by_position ? n_edges : 1LL,
                log_strip, log_rows);
      });
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  if (part != nullptr && n_edges > 0)
    spmm_sddmm_sum_kernel<W><<<edge_grid, kThreads, 0, s>>>(
        eid, part, dw, n_edges, heads, n_strips, vec4(dw));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1. Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without launching when vec_bytes is not one
// f32_vec_ok allows (16: float4, d % 4 == 0, x and y 16-byte aligned; 4:
// one float), when log_strip is negative or wider than the row's G, when R
// rows of a strip do not fit in a warp (log_strip + log_rows > 5), or when
// the library holds no instance of (unroll, reg_cap) (see with_instances
// and K1Pick). The caller allocates y [n_rows, d] and makes sure
// n_rows > 0, d > 0, that the strips fit the grid's second dimension
// (fewer than 2^16) and n_rows < 2^31 - 32. vec_bytes: the vector a row
// loads in; log_rows: log2 of the rows per warp; log_strip: log2 of the
// vectors of a strip, the lanes of an edge group; unroll: the gathers an
// edge group issues before it adds them; reg_cap: registers per thread (0:
// none; 64: 4 blocks of 8 warps per SM).
int spmm_csr_f32(const int* indptr, const int* col, const int* eid,
                 const float* w, const float* x, float* y, int n_rows, int d,
                 int vec_bytes, int log_rows, int log_strip, int unroll,
                 int reg_cap, void* stream) {
  if (!f32_vec_ok(d, vec_bytes, {x, y}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_bytes == 16)
    return launch_spmm_csr<float4>(indptr, col, eid, w, x, y, n_rows, d / 4,
                                   log_rows, log_strip, unroll, reg_cap, s);
  return launch_spmm_csr<float>(indptr, col, eid, w, x, y, n_rows, d,
                                log_rows, log_strip, unroll, reg_cap, s);
}

// K1 on bfloat16 rows and weights, summed in float32 and rounded once (see
// spmm_csr_kernel): as spmm_csr_f32, with vec_bytes the bytes of the
// vector a row is loaded in: 16 (8 values; d % 8 == 0, x and y
// 16-byte aligned), 8 (4 values; d % 4 == 0, 8-byte aligned) or 2 (one
// value). Anything else returns cudaErrorInvalidValue with nothing
// launched. Rows of one bf16x8 vector (d == 8) take spmm_csr_lanes_kernel
// (log_strip 0). The library holds the instances of K1Pick for each
// vector and of K1LanePick for rows of one bf16x8 vector.
int spmm_csr_bf16(const int* indptr, const int* col, const int* eid,
                  const bf16x1* w, const bf16x1* x, bf16x1* y, int n_rows,
                  int d, int vec_bytes, int log_rows, int log_strip,
                  int unroll, int reg_cap, void* stream) {
  if (!bf16_vec_ok(d, vec_bytes, {x, y}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_bytes == 16)
    return launch_spmm_csr<bf16x8>(indptr, col, eid, w, x, y, n_rows, d / 8,
                                   log_rows, log_strip, unroll, reg_cap, s);
  if (vec_bytes == 8)
    return launch_spmm_csr<bf16x4>(indptr, col, eid, w, x, y, n_rows, d / 4,
                                   log_rows, log_strip, unroll, reg_cap, s);
  return launch_spmm_csr<bf16x1>(indptr, col, eid, w, x, y, n_rows, d,
                                 log_rows, log_strip, unroll, reg_cap, s);
}

// K2. Over the sender CSR of n_rows senders and n_edges edges: dy
// [n_dy, H, d] (the receivers'), x [n_rows, H, d], w [n_edges, H] by edge
// id (NULL: unweighted); dx [n_rows, H, d] and dw [n_edges, H], every entry
// of both written. vec_bytes, log_rows, log_strip, unroll and reg_cap as
// K1's
// (see with_instances and K2Pick for the instances built). mode 1 (by
// position): the sweep reads the weights and writes the dots in sender-CSR
// order, head after head, and two passes around it move them from and to
// edge-id order (spmm_sddmm_weights_kernel, spmm_sddmm_sum_kernel); scratch
// is then H * (strips + 1) * n_edges floats (H * strips * n_edges without
// w). mode 0: the sweep reads w[eid[k], h] and writes dw[eid[k], h]
// itself, and needs H * strips * n_edges floats of scratch only where a
// head spans more than one strip of 2^log_strip vectors. mode 2 (bfloat16,
// 4 heads): the all-heads walk (launch_spmm_sddmm_heads), no scratch.
// Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue with
// nothing launched for what K1 refuses, for H * strips of 2^16 or more, for
// a missing scratch, or for a mode the rows do not take. The caller makes
// sure n_rows > 0, H > 0, d > 0 and n_edges < 2^31.
int spmm_sddmm_csr_f32(const int* indptr, const int* col, const int* eid,
                       const float* w, const float* dy, const float* x,
                       float* dx, float* dw, float* scratch, int n_rows,
                       int heads, int d, int n_edges, int vec_bytes,
                       int log_rows, int log_strip, int unroll, int reg_cap,
                       int mode, void* stream) {
  if (!f32_vec_ok(d, vec_bytes, {dy, x, dx}) || mode == 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_bytes == 16)
    return launch_spmm_sddmm<float4>(indptr, col, eid, w, dy, x, dx, dw,
                                     scratch, n_rows, heads, d / 4, n_edges,
                                     log_rows, log_strip, unroll, reg_cap,
                                     mode, s);
  return launch_spmm_sddmm<float>(indptr, col, eid, w, dy, x, dx, dw,
                                  scratch, n_rows, heads, d, n_edges,
                                  log_rows, log_strip, unroll, reg_cap,
                                  mode, s);
}

// K2 on bfloat16 rows, weights and dots (w and dw [E, H] bfloat16), summed
// in float32 and each output rounded once (see spmm_sddmm_csr_kernel): as
// spmm_sddmm_csr_f32, with vec_bytes as spmm_csr_bf16 takes it (the rows
// dy, x and dx). The scratch is as many floats as
// spmm_sddmm_csr_f32's; by position, its last H * n_edges floats hold the
// bfloat16 weights in sender-CSR order (half of them used). Mode 2, the
// all-heads walk, takes 4 heads of bf16x8 rows (vec_bytes 16). The library
// holds the instances of K2Bf16Pick for each vector and K2WalkPick's for
// the all-heads walk.
int spmm_sddmm_csr_bf16(const int* indptr, const int* col, const int* eid,
                        const bf16x1* w, const bf16x1* dy, const bf16x1* x,
                        bf16x1* dx, bf16x1* dw, float* scratch, int n_rows,
                        int heads, int d, int n_edges, int vec_bytes,
                        int log_rows, int log_strip, int unroll, int reg_cap,
                        int mode, void* stream) {
  if (!bf16_vec_ok(d, vec_bytes, {dy, x, dx}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dv = d / (vec_bytes / 2);
  if (vec_bytes == 16)
    return launch_spmm_sddmm<bf16x8>(indptr, col, eid, w, dy, x, dx, dw,
                                     scratch, n_rows, heads, dv, n_edges,
                                     log_rows, log_strip, unroll, reg_cap,
                                     mode, s);
  if (vec_bytes == 8)
    return launch_spmm_sddmm<bf16x4>(indptr, col, eid, w, dy, x, dx, dw,
                                     scratch, n_rows, heads, dv, n_edges,
                                     log_rows, log_strip, unroll, reg_cap,
                                     mode, s);
  return launch_spmm_sddmm<bf16x1>(indptr, col, eid, w, dy, x, dx, dw,
                                   scratch, n_rows, heads, dv, n_edges,
                                   log_rows, log_strip, unroll, reg_cap,
                                   mode, s);
}

const char* gnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
