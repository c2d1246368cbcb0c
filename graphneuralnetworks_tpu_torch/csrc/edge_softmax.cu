// Edge softmax over a node's in-edges, with aggregation: K3 to K12, float32
// and bfloat16 (vec.cuh), for sm_90a.
//
// Replaces graphneuralnetworks_tpu/ops/pallas/edge_softmax.py:
//   K12 _flash_kernel         softmax of given per-edge logits, numerator
//                             times a dropout mask, sum of node or edge values
//   K3  _flash_gat_kernel     the same with GAT's logits
//                             lrelu(pi[r] + pj[s]) computed in the kernel
//   K4  _gat_bwd_dpi_kernel   GAT backward, dpi, over the receiver CSR
//   K5  _gat_bwd_rev_kernel   GAT backward, dpj and dv, over the sender CSR
//   K9  _flash_gatv2_kernel   GATv2: logits <a_h, lrelu(q[r] + k[s])>, values
//                             k[s] (see the GATv2 section below)
//   K10 _gatv2_bwd_fwd_kernel GATv2 backward, dq and da, over the receiver CSR
//   K11 _gatv2_bwd_rev_kernel GATv2 backward, dk, over the sender CSR
//   K6  _flash_dot_kernel     dot attention: logits lrelu(scale <q[r], k[s]>),
//                             values v[s] (see the dot section below)
//   K7  _dot_bwd_dq_kernel    dot attention backward, dq, receiver CSR
//   K8  _dot_bwd_dkv_kernel   dot attention backward, dk and dv, sender CSR
//
// Layouts (row-major, contiguous):
//   indptr int32[n_rows + 1], col int32[E]   a CSR grouping of the edges
//   per-node scalars pi, pj, mx, den, s_n     [rows, H]
//   per-edge logits and masks                 [E, H], by edge id
//   node values v, dy, dv, num                [rows, H, D]
//   edge values                               [E, H, D], by edge id
// Edges are stored sorted by receiver, so a position of the receiver CSR is
// the edge id; the sender CSR's col holds the receivers.
//
// Layout of the work (every kernel; K6 and K7 also take column strips, see the
// dot section): rows. Heads go in the grid's second dimension, one after the
// other over all rows, so the resident warps gather from one head's slice of a
// node table (16 MB at N = 131,072, H = 4, D = 32, which the 50 MB L2 keeps);
// K12 with edge values, which it streams rather than gathers, puts them side
// by side in the first. A warp takes R = 2^log_rows rows side by side, each on
// 32 / R lanes, which load a window of edge indices (and the edges' own
// scalars, where a kernel reads them by CSR position) with the next window
// ahead. A head's D floats split into vectors (float4 when D % 4 == 0 and the
// row pointers are 16-byte aligned), a row's lanes into edge groups of G lanes
// (G = the vector count rounded up to a power of two, at most 32) that take
// interleaved edges, and each group issues the loads of U edges before it
// reduces any of them. A warp whose rows walk fewer index windows one after
// another on all 32 lanes (a hub among them) takes them so (walk_rows). Rows
// wider than NC * G vectors take passes. Every output entry is written once by
// one lane and every sum is taken in a fixed order, with no atomics: the same
// bits from run to run. The softmax kernels take one pass over a row's edges:
// each edge group keeps a running max, sum and accumulator, rescaled once per
// batch of U edges, and the row's groups merge by a fixed tree.
//
// Bound on an H100: memory. Each edge costs one gathered value row of H*D
// floats (512 bytes at H=4, D=32) against about 2*H*D flops and H exps.
// The compulsory traffic (each input and output once) is smaller than the
// gathered traffic, and the L2's reuse of gathered rows decides where
// between the two a kernel lands. The backward kernels (K4, K5) recompute
// the attention weight of each edge from per-node scalars (pi, pj, mx, den,
// s_n: 4 bytes each) instead of reading a stored [E, H] array.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "vec.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

__device__ __forceinline__ float warp_sum(float a) {
  for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
  return a;
}
__device__ __forceinline__ float warp_max(float a) {
  for (int off = 16; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(kFull, a, off));
  return a;
}

// leaky_relu and its slope, with slope 1 at raw == 0 (jax.nn.leaky_relu's
// where(raw >= 0, ...)).
__device__ __forceinline__ float lrelu(float raw, float slope) {
  return raw >= 0.f ? raw : slope * raw;
}
__device__ __forceinline__ float dlrelu(float raw, float slope) {
  return raw >= 0.f ? 1.f : slope;
}

// Vector forms for GATv2, whose logits need whole O-wide rows, on the sum
// types (float, float4, f8: vec.cuh).
__device__ __forceinline__ float4 lrelu(const float4& r, float slope) {
  return make_float4(lrelu(r.x, slope), lrelu(r.y, slope), lrelu(r.z, slope),
                     lrelu(r.w, slope));
}
__device__ __forceinline__ f8 lrelu(const f8& r, float slope) {
  return {lrelu(r.lo, slope), lrelu(r.hi, slope)};
}
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ f8 vadd(const f8& a, const f8& b) {
  return {vadd(a.lo, b.lo), vadd(a.hi, b.hi)};
}
// acc += w * a * lrelu'(raw), componentwise
__device__ __forceinline__ void axpy_dlrelu(float& acc, float w, float a,
                                            float raw, float slope) {
  acc = fmaf(w * a, dlrelu(raw, slope), acc);
}
__device__ __forceinline__ void axpy_dlrelu(float4& acc, float w,
                                            const float4& a, const float4& raw,
                                            float slope) {
  axpy_dlrelu(acc.x, w, a.x, raw.x, slope);
  axpy_dlrelu(acc.y, w, a.y, raw.y, slope);
  axpy_dlrelu(acc.z, w, a.z, raw.z, slope);
  axpy_dlrelu(acc.w, w, a.w, raw.w, slope);
}
__device__ __forceinline__ void axpy_dlrelu(f8& acc, float w, const f8& a,
                                            const f8& raw, float slope) {
  axpy_dlrelu(acc.lo, w, a.lo, raw.lo, slope);
  axpy_dlrelu(acc.hi, w, a.hi, raw.hi, slope);
}

// Vector f of head h's attention weights, read from a [O, H] (row-major),
// in a sum type: float (one value), float4 (4) or f8 (8; bf16x8 rows).
template <typename V>
__device__ V load_a(const float* a, int f, int heads, int h);
template <>
__device__ __forceinline__ float load_a<float>(const float* a, int f,
                                               int heads, int h) {
  return a[(long long)f * heads + h];
}
template <>
__device__ __forceinline__ float4 load_a<float4>(const float* a, int f,
                                                 int heads, int h) {
  const float* p = a + (long long)4 * f * heads + h;
  return make_float4(p[0], p[heads], p[2 * heads], p[3 * heads]);
}
template <>
__device__ __forceinline__ f8 load_a<f8>(const float* a, int f, int heads,
                                         int h) {
  return {load_a<float4>(a, 2 * f, heads, h),
          load_a<float4>(a, 2 * f + 1, heads, h)};
}

// ---- GATv2: K9, K10, K11 ---------------------------------------------------
//
// Per edge e = (r, s) and head h:  raw = q[r] + k[s] (O wide),
// act = lrelu(raw),  lg = <a[:, h], act>,  and the values are k[s] itself.
// The logit needs a whole O-wide row, not a gathered scalar as in K3, so
// each edge group reduces its lanes' shares of <a, act> (and, backward, of
// <k[s], dy[r]>) with shuffles before the exp. A lane keeps vector f = sub
// + c * G of the row for c < NC in registers (NC = 1 up to 32 vectors, and
// rows wider than that loop over NC chunks of 32, NC <= 8).
//
// Bound on an H100: memory, as K3-K5. K9 and K10 gather one k row of H*O
// floats per edge (512 bytes at H=4, O=32), K11 a q row and a dy row plus
// three per-receiver scalars. K9 reads each k row once, for the logit and
// the value both: the softmax is one pass, each edge group keeping its own
// running max, sum and accumulator (rescaled when its max grows), merged
// across groups at the end. K9, K10 and K11 take K8's rows (after the dot
// section); bfloat16 K11 on bf16x8 rows may take K8's ring instead
// (gatv2_bwd_rev_staged_kernel), as the wrapper picks it
// (ops/cuda/edge_softmax.py:_gatv2_bwd_rev_bf16_layout).

// ---- dot attention: K6, K7, K8 ---------------------------------------------
//
// Per edge e = (r, s) and head h:  raw = scale * <q[r], k[s]> (O wide),
// lg = lrelu(raw, slope), and the values v[s] (D wide; D need not equal O).
// The plain dot is slope 1: lrelu(raw, 1) == raw and its slope is 1
// everywhere, bit for bit. A head's rows split into vectors (float4 only
// when O % 4 == 0 and D % 4 == 0) and edge groups of G lanes (G = the wider
// side's vector count rounded up to a power of two, at most 32; wider rows
// in NC register chunks of G vectors); an edge group reduces its lanes'
// shares of a dot with shuffles. V, the rows' storage vector: float4 or
// float, or for bfloat16 rows bf16x8, bf16x4 or bf16x1 (vec.cuh), widened
// in registers to Acc<V>; the dots, logits, softmax state, strip partials
// and every sum are float32, and each output row is rounded once to V.
//
// Bound on an H100: memory. K6 and K7 gather one k row (H*O floats) and
// one v row (H*D floats) per edge, K8 one q and one dy row: 1 KB at H=4,
// O=D=32, and at H=1, O=D=128, 2.1 GB a call at E = 2M. The compulsory
// traffic is an eighth of that, so the L2's reuse of gathered rows decides
// where between the two a kernel lands. The first port gave one (row,
// head) pair a warp, heads interleaved in the grid, and each edge group
// waited on col[e], then the gathers, then a shuffle tree, one edge at a
// time: its warps gathered whole rows from all of the 64 MB tables, which
// the 50 MB L2 cannot hold, at 0.90-1.06x the no-L2-reuse bound.
//
// The layouts (chosen per call by ops/cuda/edge_softmax.py:_dot_recv_layout
// and _dot_bwd_rev_layout, from chip_smoke.py --sweep):
// - Rows (K6, K7 and K8 when a head is at most one 128-byte line wide, or
//   its slice of the gathered tables fits the L2): heads in the grid's
//   second dimension, one after the other over all rows, so the resident
//   warps gather one head's slice of the tables (16 MB each at N = 131,072,
//   H = 4, O = D = 32); R = 2^log_rows rows per warp, each on 32 / R lanes,
//   which load a window of 32 / R edge indices at once and the next ahead;
//   each group issues the gathers of U edges before it reduces any of
//   them; a warp whose rows walk fewer index windows one after another on
//   all 32 lanes (a hub among them) takes them so (walk_rows).
// - Strips (K6 and K7 for heads wider than a line whose tables the L2
//   cannot hold: AGNN's H = 1, O = D = 128): the logit spans the whole head,
//   so it is built in passes over 128-byte column strips, each pass
//   gathering from one strip's slice of the table (16 MB at N = 131,072),
//   which the L2 keeps, as K1's strips (spmm.cu). Partial dots per strip go
//   to an [H, strips, E] scratch buffer (dot_strip_dots_kernel); a pass per
//   row sums them in strip order into each edge's raw logit and weight
//   (dot_strip_stats_kernel); a weighted SpMM over the strips of the other
//   table writes the output (dot_strip_spmm_kernel).
// - bfloat16 K8 may instead take the staged kernel (after
//   dot_bwd_rev_kernel), as the wrapper picks it (_dot_bwd_rev_layout:
//   bfloat16's own table, as is K6's in _dot_recv_layout).
// Every output entry is written once by one lane, every sum taken in a fixed
// order: results are the same bits from run to run, with no atomics.

// Calls walk(row, beg, len, longest, log_seg) for the R = 2^log_rows rows
// of warp rb side by side, row i on the 2^log_seg = 32 / R lanes from
// i * 32 / R (len: the row's edges from beg; longest: the longest of the
// warp's rows, warp-uniform), or, where that walks fewer index windows,
// once for each row on all 32 lanes (log_seg = 5), one after another. A
// hub holds the rows beside it to its length, on 32 / R lanes: this is the
// switch of K1 (spmm.cu). The choice depends on the warp's rows alone, so
// the sums keep their order from run to run.
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
    for (int i = 0; i < 1 << log_rows; ++i) {
      const int li = __shfl_sync(kFull, len, i << log_seg);
      walk((rb << log_rows) + i, __shfl_sync(kFull, beg, i << log_seg), li,
           li, 5);
    }
  } else {
    walk(row, beg, len, longest, log_seg);
  }
}

// Where a lane of a row walk works: the row's segment of 2^log_seg lanes,
// its edge groups of 2^log_g lanes, and this lane's place in both.
struct Seg {
  int seg, first, sl, p, grp;
  __device__ Seg(int lane, int log_seg, int log_g) {
    seg = 1 << log_seg;              // lanes per row
    first = lane & ~(seg - 1);       // the row's first lane
    sl = lane & (seg - 1);           // lane within the row
    p = seg >> log_g;                // edge groups per row
    grp = sl >> log_g;
  }
  // The window position of edge u of a batch starting at j0 (U edges per
  // group, interleaved over the groups), and the lane holding its index.
  __device__ int pos(int j0, int u) const { return j0 + u * p + grp; }
  __device__ int holder(int j) const { return first + (j & (seg - 1)); }
};

// The first warp of a row-walking kernel's block, or -1 past the rows
// (blockIdx.y is a head or a strip: no division on the way to the first
// load).
__device__ __forceinline__ int row_block(int n_rows, int log_rows) {
  const int rb = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  return rb < ((n_rows + (1 << log_rows) - 1) >> log_rows) ? rb : -1;
}

// K6 in rows, replacing _flash_dot_kernel. Over the receiver CSR, row r,
// head h:
//   m = max_e lg_e,  s = sum_e exp(lg_e - m),  num = sum_e exp(lg_e - m) v[s_e]
// with m = -inf, s = 0, num = 0 for a row without edges, and raw_out[e, h]
// = raw_e where raw_out is given (K7's residual). One pass: each edge group
// keeps a running max, sum and accumulator, rescaled when the max of a
// batch of U edges exceeds it, adding its edges in CSR order; the row's
// groups then merge by a fixed shuffle tree.
template <typename V, int NC, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
dot_softmax_rows_kernel(const int* __restrict__ indptr,
                        const int* __restrict__ col, const V* __restrict__ q,
                        const V* __restrict__ k, const V* __restrict__ v,
                        V* __restrict__ num, float* __restrict__ m,
                        float* __restrict__ s, float* __restrict__ raw_out,
                        int n_rows, int heads, int ov, int dv, int log_g,
                        int log_rows, float scale, float slope) {
  const int rb = row_block(n_rows, log_rows);
  if (rb < 0) return;                        // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;
  const int sub = lane & (g - 1);
  const int h = blockIdx.y;
  using A = Acc<V>;
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_g);
    const bool live = row < n_rows;
    const long long rh = (long long)row * heads + h;
    A qv[NC], acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = sub + c * g;
      qv[c] = live && f < ov ? widen(q[rh * ov + f]) : vzero<A>();
      acc[c] = vzero<A>();
    }
    float mg = -INFINITY, sg = 0.f;   // this edge group's running max and sum
    int c = S.sl < len ? col[beg + S.sl] : 0;   // the first window
    for (int w0 = 0; w0 < longest; w0 += S.seg) {   // warp-uniform trips
      const int nc =
          w0 + S.seg + S.sl < len ? col[beg + w0 + S.seg + S.sl] : 0;
      const int cnt = min(S.seg, longest - w0);
      for (int j0 = 0; j0 < cnt; j0 += S.p * U) {   // warp-uniform trips
        V kg[U][NC], vg[U][NC];
        float lg[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {   // the gathers of U edges first
          const int j = S.pos(j0, u);
          const int src = __shfl_sync(kFull, c, S.holder(j));
          ok[u] = live && j < S.seg && w0 + j < len;
          const long long sh = (long long)src * heads + h;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            const int f = sub + cc * g;
            kg[u][cc] = ok[u] && f < ov ? k[sh * ov + f] : vzero<V>();
            vg[u][cc] = ok[u] && f < dv ? v[sh * dv + f] : vzero<V>();
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          lg[u] = 0.f;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc)
            lg[u] += vdot(qv[cc], widen(kg[u][cc]));
        }
        for (int off = 1; off < g; off <<= 1) {   // the group's G lanes
#pragma unroll
          for (int u = 0; u < U; ++u)
            lg[u] += __shfl_xor_sync(kFull, lg[u], off);
        }
        // the batch's max first, so that the group rescales once and the
        // U exps do not wait on each other
        float bm = mg;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float raw = scale * lg[u];
          if (ok[u] && raw_out != nullptr && sub == 0)
            raw_out[(long long)(beg + w0 + S.pos(j0, u)) * heads + h] = raw;
          lg[u] = ok[u] ? lrelu(raw, slope) : -INFINITY;
          bm = fmaxf(bm, lg[u]);
        }
        if (bm > mg) {
          const float sc = expf(mg - bm);   // 0 while mg is -inf
          sg *= sc;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) vscale(acc[cc], sc);
          mg = bm;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float pe = lg[u] == -INFINITY ? 0.f : expf(lg[u] - mg);
          sg += pe;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) axpy(acc[cc], pe, widen(vg[u][cc]));
        }
      }
      c = nc;
    }
    // merge the row's groups (G lanes apart): rescale each to the row max,
    // then add
    float mx = mg;
    for (int off = g; off < S.seg; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    const float sc = mg == -INFINITY ? 0.f : expf(mg - mx);
    sg *= sc;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) vscale(acc[cc], sc);
    for (int off = g; off < S.seg; off <<= 1) {
      sg += __shfl_xor_sync(kFull, sg, off);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) add_xor(acc[cc], off);
    }
    if (live && S.grp == 0) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int f = sub + cc * g;
        if (f < dv) num[rh * dv + f] = narrow<V>(acc[cc]);
      }
    }
    if (live && S.sl == 0) {
      m[rh] = mx;
      s[rh] = sg;
    }
  });
}

// K7's weight of an edge: dlg = alpha * (<v[s], dy[r]> - s_n[r]) * scale *
// lrelu'(raw), alpha = exp(lrelu(raw) - mx[r]) / den[r].
__device__ __forceinline__ float dot_dlg(float raw, float pvd, float mxr,
                                         float denr, float snr, float scale,
                                         float slope) {
  const float alpha = expf(lrelu(raw, slope) - mxr) / denr;
  return alpha * (pvd - snr) * scale * dlrelu(raw, slope);
}

// K7 in rows, replacing _dot_bwd_dq_kernel. Over the receiver CSR, row r:
//   dq[r] = sum_e dlg_e * k[s_e]
// with raw_e read from K6's residual raw [E, H] where given, else
// recomputed from q[r] (then each edge's two dots reduce in one tree).
// dy[r] (and q[r]) and the row's mx, den and s_n stay in registers, the
// rows packed in their storage vector and widened at each dot: on bf16x8
// rows that frees 8 of the 16 registers the widened pair took, which the
// instance AGNN's rows take (2 edges in flight at 64 registers) spilled
// (20 bytes; PERF.md §6).
template <typename V, int NC, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
dot_bwd_dq_rows_kernel(const int* __restrict__ indptr,
                       const int* __restrict__ col, const V* __restrict__ q,
                       const V* __restrict__ k, const V* __restrict__ v,
                       const float* __restrict__ mx,
                       const float* __restrict__ den,
                       const float* __restrict__ s_n,
                       const V* __restrict__ dy,
                       const float* __restrict__ raw, V* __restrict__ dq,
                       int n_rows, int heads, int ov, int dv, int log_g,
                       int log_rows, float scale, float slope) {
  const int rb = row_block(n_rows, log_rows);
  if (rb < 0) return;                        // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;
  const int sub = lane & (g - 1);
  const int h = blockIdx.y;
  const bool given = raw != nullptr;         // uniform over the grid
  using A = Acc<V>;
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_g);
    const bool live = row < n_rows;
    const long long rh = (long long)row * heads + h;
    V qv[NC], dyv[NC];
    A dqa[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = sub + c * g;
      qv[c] = live && !given && f < ov ? q[rh * ov + f] : vzero<V>();
      dyv[c] = live && f < dv ? dy[rh * dv + f] : vzero<V>();
      dqa[c] = vzero<A>();
    }
    const float mxr = live ? mx[rh] : 0.f, denr = live ? den[rh] : 1.f;
    const float snr = live ? s_n[rh] : 0.f;
    // lane sl holds window position w0 + sl: its sender and raw logit
    auto fetch = [&](int w0, int& c, float& rw) {
      c = 0;
      rw = 0.f;
      if (w0 + S.sl < len) {
        const int e = beg + w0 + S.sl;
        c = col[e];
        if (given) rw = raw[(long long)e * heads + h];
      }
    };
    int c, nc;
    float rw, nrw;
    fetch(0, c, rw);
    for (int w0 = 0; w0 < longest; w0 += S.seg) {   // warp-uniform trips
      fetch(w0 + S.seg, nc, nrw);                   // the next window, ahead
      const int cnt = min(S.seg, longest - w0);
      for (int j0 = 0; j0 < cnt; j0 += S.p * U) {   // warp-uniform trips
        V kg[U][NC], vg[U][NC];
        float plg[U], pvd[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {   // the gathers of U edges first
          const int j = S.pos(j0, u);
          const int hold = S.holder(j);
          const int src = __shfl_sync(kFull, c, hold);
          plg[u] = __shfl_sync(kFull, rw, hold);
          ok[u] = live && j < S.seg && w0 + j < len;
          const long long sh = (long long)src * heads + h;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            const int f = sub + cc * g;
            kg[u][cc] = ok[u] && f < ov ? k[sh * ov + f] : vzero<V>();
            vg[u][cc] = ok[u] && f < dv ? v[sh * dv + f] : vzero<V>();
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          pvd[u] = 0.f;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc)
            pvd[u] += vdot(widen(vg[u][cc]), widen(dyv[cc]));
        }
        if (given) {
          for (int off = 1; off < g; off <<= 1) {
#pragma unroll
            for (int u = 0; u < U; ++u)
              pvd[u] += __shfl_xor_sync(kFull, pvd[u], off);
          }
        } else {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            plg[u] = 0.f;
#pragma unroll
            for (int cc = 0; cc < NC; ++cc)
              plg[u] += vdot(widen(qv[cc]), widen(kg[u][cc]));
          }
          for (int off = 1; off < g; off <<= 1) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
              plg[u] += __shfl_xor_sync(kFull, plg[u], off);
              pvd[u] += __shfl_xor_sync(kFull, pvd[u], off);
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) plg[u] *= scale;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!ok[u]) continue;
          const float dlg =
              dot_dlg(plg[u], pvd[u], mxr, denr, snr, scale, slope);
#pragma unroll
          for (int cc = 0; cc < NC; ++cc)
            axpy(dqa[cc], dlg, widen(kg[u][cc]));
        }
      }
      c = nc;
      rw = nrw;
    }
    for (int off = g; off < S.seg; off <<= 1) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) add_xor(dqa[cc], off);
    }
    if (live && S.grp == 0) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int f = sub + cc * g;
        if (f < ov) dq[rh * ov + f] = narrow<V>(dqa[cc]);
      }
    }
  });
}

// The strip passes. Block column y = h * n_strips + j takes strip j (vectors
// j * S + sub, S = 2^log_s lanes an edge group: one 128-byte line) of head
// h, so the grid runs head by head, strip after strip, over all rows. KK
// (6 or 7) names the kernel a pass serves, so a profile tells them apart.

// part[y, e] = <a[r, h, strip j], b[s_e, h, strip j]> over the receiver
// CSR: K6's partial logits (a = q, b = k) and K7's partial <v[s], dy[r]>
// (a = dy, b = v).
template <int KK, typename V, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
dot_strip_dots_kernel(const int* __restrict__ indptr,
                      const int* __restrict__ col, const V* __restrict__ a,
                      const V* __restrict__ b, float* __restrict__ part,
                      int n_rows, int heads, int width, int n_strips,
                      long long n_edges, int log_s, int log_rows) {
  const int rb = row_block(n_rows, log_rows);
  if (rb < 0) return;                        // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_s;
  const int sub = lane & (g - 1);
  const int h = blockIdx.y / n_strips;
  const int f = (blockIdx.y - h * n_strips) * g + sub;
  const bool active = f < width;
  float* out = part + (long long)blockIdx.y * n_edges;
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_s);
    const bool live = row < n_rows;
    const Acc<V> av = live && active
                          ? widen(a[((long long)row * heads + h) * width + f])
                          : vzero<Acc<V>>();
    int c = S.sl < len ? col[beg + S.sl] : 0;
    for (int w0 = 0; w0 < longest; w0 += S.seg) {   // warp-uniform trips
      const int nc =
          w0 + S.seg + S.sl < len ? col[beg + w0 + S.seg + S.sl] : 0;
      const int cnt = min(S.seg, longest - w0);
      for (int j0 = 0; j0 < cnt; j0 += S.p * U) {   // warp-uniform trips
        V bg[U];
        float dt[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = S.pos(j0, u);
          const int src = __shfl_sync(kFull, c, S.holder(j));
          ok[u] = live && j < S.seg && w0 + j < len;
          bg[u] = ok[u] && active
                      ? b[((long long)src * heads + h) * width + f]
                      : vzero<V>();
        }
#pragma unroll
        for (int u = 0; u < U; ++u) dt[u] = vdot(av, widen(bg[u]));
        for (int off = 1; off < g; off <<= 1) {
#pragma unroll
          for (int u = 0; u < U; ++u)
            dt[u] += __shfl_xor_sync(kFull, dt[u], off);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (ok[u] && sub == 0) out[beg + w0 + S.pos(j0, u)] = dt[u];
      }
      c = nc;
    }
  });
}

// One warp per (receiver row, head), lanes over the row's edges. KK == 6:
// raw_e = scale * (the sum of part_lg's strips in order), written to raw
// [E, H]; the row's m and s; the weight w[h, e] = exp(lg_e - m). KK == 7:
// raw_e from raw where given, else from part_lg as for K6; pvd_e the sum of
// part_vd's strips; w[h, e] = dlg_e (dot_dlg).
template <int KK>
__global__ void __launch_bounds__(kThreads)
dot_strip_stats_kernel(const int* __restrict__ indptr,
                       const float* __restrict__ part_lg, int lg_strips,
                       const float* __restrict__ part_vd, int vd_strips,
                       float* __restrict__ raw, const float* __restrict__ mx,
                       const float* __restrict__ den,
                       const float* __restrict__ s_n, float* __restrict__ w,
                       float* __restrict__ m, float* __restrict__ s,
                       int n_rows, int heads, long long n_edges, float scale,
                       float slope) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;                 // warp-uniform
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.y;
  const long long rh = (long long)row * heads + h;
  const int beg = indptr[row], end = indptr[row + 1];
  float* wh = w + (long long)h * n_edges;
  auto strip_sum = [&](const float* part, int n, int e) {
    float t = 0.f;
    for (int j = 0; j < n; ++j) t += part[((long long)h * n + j) * n_edges + e];
    return t;
  };
  if constexpr (KK == 6) {
    float ml = -INFINITY;
    for (int e = beg + lane; e < end; e += 32) {
      const float r = scale * strip_sum(part_lg, lg_strips, e);
      raw[(long long)e * heads + h] = r;
      ml = fmaxf(ml, lrelu(r, slope));
    }
    const float mr = warp_max(ml);
    float sl = 0.f;
    for (int e = beg + lane; e < end; e += 32) {   // this lane's own writes
      const float l = lrelu(raw[(long long)e * heads + h], slope);
      const float pe = l == -INFINITY ? 0.f : expf(l - mr);
      wh[e] = pe;
      sl += pe;
    }
    sl = warp_sum(sl);
    if (lane == 0) {
      m[rh] = mr;
      s[rh] = sl;
    }
  } else {
    const float mxr = mx[rh], denr = den[rh], snr = s_n[rh];
    for (int e = beg + lane; e < end; e += 32) {
      const float r = raw != nullptr ? raw[(long long)e * heads + h]
                                     : scale * strip_sum(part_lg, lg_strips, e);
      wh[e] = dot_dlg(r, strip_sum(part_vd, vd_strips, e), mxr, denr, snr,
                      scale, slope);
    }
  }
}

// out[r, h, strip j] = sum_e w[h, e] * x[s_e, h, strip j] over the receiver
// CSR, shaped as K1 (spmm.cu): K6's num (x = v, w = exp(lg - m)) and K7's
// dq (x = k, w = dlg). Rows without edges are written as zeros.
template <int KK, typename V, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
dot_strip_spmm_kernel(const int* __restrict__ indptr,
                      const int* __restrict__ col,
                      const float* __restrict__ w, const V* __restrict__ x,
                      V* __restrict__ out, int n_rows, int heads, int width,
                      int n_strips, long long n_edges, int log_s,
                      int log_rows) {
  const int rb = row_block(n_rows, log_rows);
  if (rb < 0) return;                        // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_s;
  const int sub = lane & (g - 1);
  const int h = blockIdx.y / n_strips;
  const int f = (blockIdx.y - h * n_strips) * g + sub;
  const bool active = f < width;
  const float* wh = w + (long long)h * n_edges;
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_s);
    const bool live = row < n_rows;
    auto fetch = [&](int w0, int& c, float& wt) {
      c = 0;
      wt = 0.f;
      if (w0 + S.sl < len) {
        c = col[beg + w0 + S.sl];
        wt = wh[beg + w0 + S.sl];
      }
    };
    int c, nc;
    float wt, nwt;
    fetch(0, c, wt);
    Acc<V> acc = vzero<Acc<V>>();
    for (int w0 = 0; w0 < longest; w0 += S.seg) {   // warp-uniform trips
      fetch(w0 + S.seg, nc, nwt);                   // the next window, ahead
      const int cnt = min(S.seg, longest - w0);
      for (int j0 = 0; j0 < cnt; j0 += S.p * U) {   // warp-uniform trips
        V xg[U];
        float wj[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = S.pos(j0, u);
          const int hold = S.holder(j);
          const int src = __shfl_sync(kFull, c, hold);
          wj[u] = __shfl_sync(kFull, wt, hold);
          const bool ok = live && active && j < S.seg && w0 + j < len;
          if (!ok) wj[u] = 0.f;
          xg[u] = ok ? x[((long long)src * heads + h) * width + f]
                     : vzero<V>();
        }
#pragma unroll
        for (int u = 0; u < U; ++u) axpy(acc, wj[u], widen(xg[u]));
      }
      c = nc;
      wt = nwt;
    }
    for (int off = g; off < S.seg; off <<= 1) add_xor(acc, off);
    if (live && active && S.grp == 0)
      out[((long long)row * heads + h) * width + f] = narrow<V>(acc);
  });
}

// K8, replacing _dot_bwd_dkv_kernel. Over the sender CSR, row s (col holds
// the receivers r_e), with alpha_e and dlg_e as in K7:
//   dk[s] = sum_e dlg_e * q[r_e],   dv[s] = sum_e alpha_e * dy[r_e].
// k[s] and v[s] stay in registers; each gathered q row feeds the logit and
// dk, each gathered dy row <v[s], dy[r]> and dv. Rows, as K6 and K7 (see
// above): heads in the grid's second dimension make the resident warps
// gather one head's slices of q and dy (32 MB at N = 131,072, H = 4, O = D
// = 32, which the L2 holds). Putting a row's heads side by side on a warp,
// to load a receiver's index and scalars once for all of them, measured
// slower (chip_smoke.py --sweep, an H100 at 700 W: 0.737 ms against 0.587
// for one head per warp and 0.840 for the first port, PERF.md §6). Each
// group loads U edges' receiver scalars, q and dy rows before it reduces
// any of their dots.
template <typename V, int NC, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
dot_bwd_rev_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                   const V* __restrict__ q, const V* __restrict__ k,
                   const V* __restrict__ v, const float* __restrict__ mx,
                   const float* __restrict__ den,
                   const float* __restrict__ s_n, const V* __restrict__ dy,
                   V* __restrict__ dk, V* __restrict__ dv_out, int n_rows,
                   int heads, int ov, int dv, int log_g, int log_rows,
                   float scale, float slope) {
  const int rb = row_block(n_rows, log_rows);
  if (rb < 0) return;                        // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;                  // lanes per edge group
  const int sub = lane & (g - 1);
  const int h = blockIdx.y;
  using A = Acc<V>;
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_g);
    const bool live = row < n_rows;
    const long long sh = (long long)row * heads + h;
    A kv[NC], vv[NC], dka[NC], dva[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = sub + c * g;
      kv[c] = live && f < ov ? widen(k[sh * ov + f]) : vzero<A>();
      vv[c] = live && f < dv ? widen(v[sh * dv + f]) : vzero<A>();
      dka[c] = vzero<A>();
      dva[c] = vzero<A>();
    }
    int c = S.sl < len ? col[beg + S.sl] : 0;   // the first window
    for (int w0 = 0; w0 < longest; w0 += S.seg) {   // warp-uniform trips
      const int nc =
          w0 + S.seg + S.sl < len ? col[beg + w0 + S.seg + S.sl] : 0;
      const int cnt = min(S.seg, longest - w0);
      for (int j0 = 0; j0 < cnt; j0 += S.p * U) {   // warp-uniform trips
        V qg[U][NC], dyg[U][NC];
        float mxr[U], denr[U], snr[U], plg[U], pvd[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {   // the loads of U edges first
          const int j = S.pos(j0, u);
          const int r = __shfl_sync(kFull, c, S.holder(j));
          ok[u] = live && j < S.seg && w0 + j < len;
          const long long rh = (long long)r * heads + h;
          mxr[u] = ok[u] ? mx[rh] : 0.f;
          denr[u] = ok[u] ? den[rh] : 1.f;
          snr[u] = ok[u] ? s_n[rh] : 0.f;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            const int f = sub + cc * g;
            qg[u][cc] = ok[u] && f < ov ? q[rh * ov + f] : vzero<V>();
            dyg[u][cc] = ok[u] && f < dv ? dy[rh * dv + f] : vzero<V>();
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          plg[u] = 0.f;
          pvd[u] = 0.f;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            plg[u] += vdot(widen(qg[u][cc]), kv[cc]);
            pvd[u] += vdot(vv[cc], widen(dyg[u][cc]));
          }
        }
        for (int off = 1; off < g; off <<= 1) {   // the group's G lanes
#pragma unroll
          for (int u = 0; u < U; ++u) {
            plg[u] += __shfl_xor_sync(kFull, plg[u], off);
            pvd[u] += __shfl_xor_sync(kFull, pvd[u], off);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!ok[u]) continue;
          const float raw = scale * plg[u];
          const float alpha = expf(lrelu(raw, slope) - mxr[u]) / denr[u];
          const float dlg =
              alpha * (pvd[u] - snr[u]) * scale * dlrelu(raw, slope);
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            axpy(dka[cc], dlg, widen(qg[u][cc]));
            axpy(dva[cc], alpha, widen(dyg[u][cc]));
          }
        }
      }
      c = nc;
    }
    // the groups' lanes of one vector are G apart, within the row's lanes
    for (int off = g; off < S.seg; off <<= 1) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        add_xor(dka[cc], off);
        add_xor(dva[cc], off);
      }
    }
    if (live && S.grp == 0) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int f = sub + cc * g;
        if (f < ov) dk[sh * ov + f] = narrow<V>(dka[cc]);
        if (f < dv) dv_out[sh * dv + f] = narrow<V>(dva[cc]);
      }
    }
  });
}

// ---- bfloat16 K8: gathers staged in shared memory ------------------------
//
// The register kernel above holds each group's U gathered edges in
// registers until the group reduces them. On bfloat16 rows a lane widens
// its vector to Acc<V> (8 floats for bf16x8), so K8's k, v, dk and dv
// state alone takes 32 registers at 4 lanes a 64-byte row, twice
// float32's, and U = 2 edges of q and dy at a cap of 64 registers spill.
// This kernel keeps the walk (walk_rows, Seg: R rows a warp, groups of G
// lanes taking interleaved edges, the hub switch), the arithmetic and its
// order (each group adds its edges in CSR order, the row's groups merge by
// the same tree: the register kernel's bits at the same rows), but buys
// edges in flight with shared memory instead of registers:
// - Lanes take bf16x8 vectors (dot_bf16_vec). bf16x4 lanes at O = 32 (8
//   lanes a row, float4 state as wide as float32's) measured slower in
//   every layout of chip_smoke.py --sweep bf16 (an H100 at 700 W: K8 at
//   best 0.570 against 0.441 ms, K6 0.435 against 0.374; PERF.md §6).
// - Each warp keeps a ring of NS stages, each holding U edges of every
//   group: each lane's q and dy vectors and the receiver's (mx, den, s_n)
//   packed as one float4 [rows, H, 4] by the wrapper: one 16-byte copy an
//   edge instead of three 4-byte loads. Each lane fills its own slots with
//   cp.async.cg (16 bytes, through the L2 only) and reads back only what
//   it copied, so the ring needs no barrier beyond cp.async.wait_group;
//   while a group reduces stage t, stages t + 1 to t + NS - 1 are in
//   flight. TMA's tiled mode cannot gather rows by an index, and
//   cp.async.bulk would take one elected lane a row and an mbarrier a
//   stage for rows of 16 to 256 bytes.
// - The receivers of a stage are loaded one stage before their copies are
//   issued, so no copy waits on col.
// - The row's own vectors (k[s], v[s]) stay packed and are widened at each
//   dot, and a staged vector is widened again from its slot for the sums
//   rather than held across the shuffles: at U = 2 edges a stage the
//   kernel takes 78 registers uncapped and no spill, where the register
//   kernel at U = 2 spills 168 bytes at its cap of 64.
// Shared memory: kWarpsPerBlock * NS * U slots of 32 * NC * 32 + 512
// bytes. The shipped picks (NS = 2, U = 2 or 1): 48 KB a block at one
// chunk, so 4 blocks fit an SM's 228 KB and the 78 registers (3 blocks of
// 8 warps) bind first; two stages were the fastest ring in the sweep, more
// stages cost blocks without gaining. Rows of any width (NC register
// chunks of 32 vectors; past one chunk one edge, two stages: 139 KB a
// block at NC = 8, one block an SM). K6 keeps the register kernel on
// bfloat16: the same ring for K6's k and v gained 0.00015 ms at (1, 8, 8)
// and lost 0.015 and 0.037 ms at (4, 32, 32) and (1, 128, 128) in that
// sweep.

// one lane's slots of a stage: its gathered q and dy vectors and the
// receiver's packed scalars
template <typename V, int NC>
struct RevSlot {
  V a[NC][32], b[NC][32];
  float4 st[32];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
template <typename V>
__device__ __forceinline__ void cp_async(V* dst, const V* src) {
  static_assert(sizeof(V) == 16, "cp.async.cg copies 16 bytes");
  cp_async16(dst, src);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Runs a lane's ring over a row walk of n_st stages of U edges per group:
// next(t, u) is stage t's edge u's gathered row index (-1: none),
// issue(slot, r) the copies of that edge into its slots (called by every
// lane, r < 0 where it has no edge), and reduce(t, slot) the reduction of
// stage t once it has landed. Stage t's indices are loaded one stage
// before its copies are issued. kShared: lanes copy into each other's
// slots, so a __syncwarp() after each wait (and after the walk) makes the
// partners' copies visible and keeps a slot's next copies behind every
// lane's reads of it.
template <int U, int NS, bool kShared = false, typename Slot, typename Next,
          typename Issue, typename Reduce>
__device__ __forceinline__ void staged_walk(Slot* ring, int n_st, Next&& next,
                                            Issue&& issue, Reduce&& reduce) {
  static_assert(NS >= 2, "a ring of at least two stages");
  auto copy = [&](int t, const int (&r)[U]) {
    Slot* slot = ring + (t % NS) * U;
#pragma unroll
    for (int u = 0; u < U; ++u) issue(slot + u, r[u]);
    cp_async_commit();   // an empty group past the walk's end
  };
  int rn[U];
  {
    int r0[NS - 1][U];   // the prologue's indices, all loads first
#pragma unroll
    for (int t = 0; t < NS - 1; ++t)
#pragma unroll
      for (int u = 0; u < U; ++u) r0[t][u] = next(t, u);
#pragma unroll
    for (int t = 0; t < NS - 1; ++t) copy(t, r0[t]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) rn[u] = next(NS - 1, u);
  for (int t = 0; t < n_st; ++t) {   // warp-uniform trips
    cp_async_wait<NS - 2>();         // stage t has landed
    if constexpr (kShared) __syncwarp();
    copy(t + NS - 1, rn);            // into the slots stage t - 1 left
#pragma unroll
    for (int u = 0; u < U; ++u) rn[u] = next(t + NS, u);
    reduce(t, ring + (t % NS) * U);
  }
  cp_async_wait<0>();
  if constexpr (kShared) __syncwarp();   // before a next walk's copies
}

// K8 on bfloat16 vectors, staged (see above): dot_bwd_rev_kernel's
// function at NC register chunks, U edges a stage, NS stages, the
// receivers' scalars packed (stats [rows, H, 4]: mx, den, s_n, unused).
template <typename V, int NC, int U, int NS, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
dot_bwd_rev_staged_kernel(const int* __restrict__ indptr,
                          const int* __restrict__ col,
                          const V* __restrict__ q, const V* __restrict__ k,
                          const V* __restrict__ v,
                          const float4* __restrict__ stats,
                          const V* __restrict__ dy, V* __restrict__ dk,
                          V* __restrict__ dv_out, int n_rows, int heads,
                          int ov, int dv, int log_g, int log_rows,
                          float scale, float slope) {
  extern __shared__ __align__(16) unsigned char staged_smem[];
  const int rb = row_block(n_rows, log_rows);
  if (rb < 0) return;                        // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;                  // lanes per edge group
  const int sub = lane & (g - 1);
  const int h = blockIdx.y;
  using A = Acc<V>;
  using Slot = RevSlot<V, NC>;
  Slot* ring = reinterpret_cast<Slot*>(staged_smem) + (threadIdx.x >> 5) * NS * U;
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_g);
    const bool live = row < n_rows;
    const long long sh = (long long)row * heads + h;
    // k[s] and v[s] stay packed, widened at each dot, and a gathered
    // vector is widened again from its slot for the sums rather than held
    // across the shuffles: registers. Past 4 chunks (rows of more than
    // 1,024 values) they are read again (from L1) at each dot: the 128
    // floats of dk and dv leave no room for them.
    constexpr int NH = NC > 4 ? 1 : NC;
    V kv[NH], vv[NH];
    A dka[NC], dva[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = sub + c * g;
      if constexpr (NC <= 4) {
        kv[c] = live && f < ov ? k[sh * ov + f] : vzero<V>();
        vv[c] = live && f < dv ? v[sh * dv + f] : vzero<V>();
      }
      dka[c] = vzero<A>();
      dva[c] = vzero<A>();
    }
    auto k_at = [&](int c) -> V {
      if constexpr (NC > 4) {
        return k[sh * ov + sub + c * g];   // f < ov: the caller's test
      } else {
        return kv[c];
      }
    };
    auto v_at = [&](int c) -> V {
      if constexpr (NC > 4) {
        return v[sh * dv + sub + c * g];
      } else {
        return vv[c];
      }
    };
    auto pos = [&](int t, int u) { return (t * U + u) * S.p + S.grp; };
    const int per = S.p * U;
    staged_walk<U, NS>(
        ring, (longest + per - 1) / per,
        [&](int t, int u) {
          const int j = pos(t, u);
          return live && j < len ? col[beg + j] : -1;
        },
        [&](Slot* slot, int r) {
          if (r < 0) return;
          const long long rh = (long long)r * heads + h;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int f = sub + c * g;
            if (f < ov) cp_async(&slot->a[c][lane], q + rh * ov + f);
            if (f < dv) cp_async(&slot->b[c][lane], dy + rh * dv + f);
          }
          cp_async(&slot->st[lane], stats + rh);
        },
        [&](int t, const Slot* slot) {
          float plg[U], pvd[U];
          bool ok[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            ok[u] = live && pos(t, u) < len;
            plg[u] = 0.f;
            pvd[u] = 0.f;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const int f = sub + c * g;
              if (ok[u] && f < ov)
                plg[u] += vdot(widen(slot[u].a[c][lane]), widen(k_at(c)));
              if (ok[u] && f < dv)
                pvd[u] += vdot(widen(v_at(c)), widen(slot[u].b[c][lane]));
            }
          }
          for (int off = 1; off < g; off <<= 1) {   // the group's G lanes
#pragma unroll
            for (int u = 0; u < U; ++u) {
              plg[u] += __shfl_xor_sync(kFull, plg[u], off);
              pvd[u] += __shfl_xor_sync(kFull, pvd[u], off);
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (!ok[u]) continue;
            const float4 st = slot[u].st[lane];   // mx, den, s_n
            const float raw = scale * plg[u];
            const float alpha = expf(lrelu(raw, slope) - st.x) / st.y;
            const float dlg =
                alpha * (pvd[u] - st.z) * scale * dlrelu(raw, slope);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const int f = sub + c * g;
              if (f < ov) axpy(dka[c], dlg, widen(slot[u].a[c][lane]));
              if (f < dv) axpy(dva[c], alpha, widen(slot[u].b[c][lane]));
            }
          }
        });
    for (int off = g; off < S.seg; off <<= 1) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        add_xor(dka[c], off);
        add_xor(dva[c], off);
      }
    }
    if (live && S.grp == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int f = sub + c * g;
        if (f < ov) dk[sh * ov + f] = narrow<V>(dka[c]);
        if (f < dv) dv_out[sh * dv + f] = narrow<V>(dva[c]);
      }
    }
  });
}

// K11, replacing _gatv2_bwd_rev_kernel. Over the sender CSR, row s (col
// holds the receivers r_e), head h:
//   dk[s] = sum_e dlg_e * a * lrelu'(raw_e) + alpha_e * dy[r_e]
// with raw_e = q[r_e] + k[s], alpha_e = exp(<a, lrelu(raw_e)> - mx[r]) /
// den[r] and dlg_e = alpha_e * (<k[s], dy[r]> - s_n[r]): the logit half and
// the value half (values are k) in one sum. K8's rows (see
// dot_bwd_rev_kernel): heads in the grid's second dimension, so the
// resident warps gather one head's slices of q and dy; R rows per warp, the
// window of receiver indices loaded ahead; each group loads U edges'
// receiver scalars, q and dy rows before it reduces any of their dots, and
// reduces both dots of the U edges in one shuffle tree; the hub switch
// (walk_rows). k[s] and a stay in registers. With stats, each receiver's
// (mx, den, s_n) come packed as one float4 [rows, H, 4]: one 16-byte load
// an edge in place of three 4-byte ones. The first port gave a (row,
// head) pair a warp, heads interleaved in the grid, and waited on col[e],
// then the receiver's scalars and rows, then the tree, one edge at a time.
// V, the rows' storage vector, as K9's.
template <typename V, int NC, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
gatv2_bwd_rev_kernel(const int* __restrict__ indptr,
                     const int* __restrict__ col, const V* __restrict__ q,
                     const V* __restrict__ k, const float* __restrict__ a,
                     const float* __restrict__ mx,
                     const float* __restrict__ den,
                     const float* __restrict__ s_n,
                     const float4* __restrict__ stats,
                     const V* __restrict__ dy, V* __restrict__ dk,
                     int n_rows, int heads, int dv, int log_g, int log_rows,
                     float slope) {
  const int rb = row_block(n_rows, log_rows);
  if (rb < 0) return;                        // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;                  // lanes per edge group
  const int sub = lane & (g - 1);
  const int h = blockIdx.y;
  using A = Acc<V>;
  A av[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int f = sub + c * g;
    av[c] = f < dv ? load_a<A>(a, f, heads, h) : vzero<A>();
  }
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_g);
    const bool live = row < n_rows;
    const long long sh = (long long)row * heads + h;
    A kv[NC], acc[NC];
    // k and dk stream past the L2 (evict-first), which keeps the head's
    // slices of q and dy that the pass gathers from
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = sub + c * g;
      kv[c] = live && f < dv ? widen(ld_cs(k + sh * dv + f)) : vzero<A>();
      acc[c] = vzero<A>();
    }
    int c = S.sl < len ? col[beg + S.sl] : 0;   // the first window
    for (int w0 = 0; w0 < longest; w0 += S.seg) {   // warp-uniform trips
      const int nc =
          w0 + S.seg + S.sl < len ? col[beg + w0 + S.seg + S.sl] : 0;
      const int cnt = min(S.seg, longest - w0);
      for (int j0 = 0; j0 < cnt; j0 += S.p * U) {   // warp-uniform trips
        A raw[U][NC];
        V dyg[U][NC];
        float mxr[U], denr[U], snr[U], plg[U], pvd[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {   // the loads of U edges first
          const int j = S.pos(j0, u);
          const int r = __shfl_sync(kFull, c, S.holder(j));
          ok[u] = live && j < S.seg && w0 + j < len;
          const long long rh = (long long)r * heads + h;
          if (stats) {   // one 16-byte load for the three (uniform)
            const float4 st =
                ok[u] ? stats[rh] : make_float4(0.f, 1.f, 0.f, 0.f);
            mxr[u] = st.x;
            denr[u] = st.y;
            snr[u] = st.z;
          } else {
            mxr[u] = ok[u] ? mx[rh] : 0.f;
            denr[u] = ok[u] ? den[rh] : 1.f;
            snr[u] = ok[u] ? s_n[rh] : 0.f;
          }
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            const int f = sub + cc * g;
            raw[u][cc] =
                ok[u] && f < dv ? widen(q[rh * dv + f]) : vzero<A>();
            dyg[u][cc] = ok[u] && f < dv ? dy[rh * dv + f] : vzero<V>();
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          plg[u] = 0.f;
          pvd[u] = 0.f;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            raw[u][cc] = vadd(raw[u][cc], kv[cc]);
            plg[u] += vdot(av[cc], lrelu(raw[u][cc], slope));
            pvd[u] += vdot(kv[cc], widen(dyg[u][cc]));
          }
        }
        for (int off = 1; off < g; off <<= 1) {   // the group's G lanes
#pragma unroll
          for (int u = 0; u < U; ++u) {
            plg[u] += __shfl_xor_sync(kFull, plg[u], off);
            pvd[u] += __shfl_xor_sync(kFull, pvd[u], off);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!ok[u]) continue;
          const float alpha = expf(plg[u] - mxr[u]) / denr[u];
          const float dlg = alpha * (pvd[u] - snr[u]);
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            axpy_dlrelu(acc[cc], dlg, av[cc], raw[u][cc], slope);
            axpy(acc[cc], alpha, widen(dyg[u][cc]));
          }
        }
      }
      c = nc;
    }
    // the groups' lanes of one vector are G apart, within the row's lanes
    for (int off = g; off < S.seg; off <<= 1) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) add_xor(acc[cc], off);
    }
    if (live && S.grp == 0) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int f = sub + cc * g;
        if (f < dv) st_cs(dk + sh * dv + f, narrow<V>(acc[cc]));
      }
    }
  });
}

// K11 on bfloat16 vectors, staged: gatv2_bwd_rev_kernel's function on K8's
// ring (staged_walk, RevSlot; see dot_bwd_rev_staged_kernel). K11 gathers
// K8's operands over the sender CSR: q[r], dy[r] and the receiver's (mx,
// den, s_n). The register kernel holds each group's U gathered edges
// widened until the group reduces them (raw[U][NC] and dy[U][NC]) beside
// k[s], a and dk: on bf16x8 vectors 8 floats a lane each, twice float32's,
// and it spilled (PERF.md §7). Here a lane's q[r] vectors go to slot a of a
// stage, its dy[r] vectors to slot b and the receiver's packed scalars
// (stats [rows, H, 4]: mx, den, s_n, unused) to st, by cp.async.cg of 16
// bytes each; k[s] stays packed and is widened at each use, and raw =
// q[r] + k[s] is formed again from the slot after the shuffles rather
// than held across them. Past 4 register chunks k[s] and a are read again
// at each use (from L1), as K8's k and v. The arithmetic and its order are
// K11's: each group adds its edges in CSR order, and the row's groups
// merge by the same tree. NC register chunks, U edges a stage, NS stages.
//
// Gathered at random, every 16-byte q[r], dy[r] or stats[r] costs an L2
// sector (32 bytes) of its own: three an edge at 16-byte rows (O = 8, a
// lane a group). With kRecord (16-byte rows only), the wrapper packs each
// receiver's q[r] and scalars into one 32-byte record [rows, H, 8 floats]
// (stats: q's 16 bytes, then mx, den, s_n, unused), and a lane pair copies
// the two halves of one record in one instruction, one sector for both:
// the pair's even lane's edge's record, then its odd lane's, each half into
// its owner's slot (kShared's __syncwarp in staged_walk). Two sectors an
// edge, with dy[r]: 0.0585 against 0.0604 ms at (1, 8) (PERF.md §6), so
// the kernel runs at a rate of gathers more than of sectors.
template <typename V, int NC, int U, int NS, int MINB, bool kRecord = false>
__global__ void __launch_bounds__(kThreads, MINB)
gatv2_bwd_rev_staged_kernel(const int* __restrict__ indptr,
                            const int* __restrict__ col,
                            const V* __restrict__ q, const V* __restrict__ k,
                            const float* __restrict__ a,
                            const float4* __restrict__ stats,
                            const V* __restrict__ dy, V* __restrict__ dk,
                            int n_rows, int heads, int dv, int log_g,
                            int log_rows, float slope) {
  extern __shared__ __align__(16) unsigned char staged_smem[];
  const int rb = row_block(n_rows, log_rows);
  if (rb < 0) return;                        // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;                  // lanes per edge group
  const int sub = lane & (g - 1);
  const int h = blockIdx.y;
  using A = Acc<V>;
  using Slot = RevSlot<V, NC>;
  Slot* ring =
      reinterpret_cast<Slot*>(staged_smem) + (threadIdx.x >> 5) * NS * U;
  constexpr int NH = NC > 4 ? 1 : NC;        // chunks held in registers
  A av[NH];
#pragma unroll
  for (int c = 0; c < NH; ++c) {
    const int f = sub + c * g;
    av[c] = NC <= 4 && f < dv ? load_a<A>(a, f, heads, h) : vzero<A>();
  }
  auto a_at = [&](int c) -> A {
    if constexpr (NC > 4) {
      return load_a<A>(a, sub + c * g, heads, h);   // f < dv: the caller's
    } else {
      return av[c];
    }
  };
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_g);
    const bool live = row < n_rows;
    const long long sh = (long long)row * heads + h;
    // k and dk stream past the L2 (evict-first), which keeps the head's
    // slices of q and dy that the pass gathers from
    V kv[NH];
    A acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = sub + c * g;
      if constexpr (NC <= 4)
        kv[c] = live && f < dv ? ld_cs(k + sh * dv + f) : vzero<V>();
      acc[c] = vzero<A>();
    }
    auto k_at = [&](int c) -> V {
      if constexpr (NC > 4) {
        return k[sh * dv + sub + c * g];   // f < dv: the caller's test
      } else {
        return kv[c];
      }
    };
    auto pos = [&](int t, int u) { return (t * U + u) * S.p + S.grp; };
    const int per = S.p * U;
    staged_walk<U, NS, kRecord>(
        ring, (longest + per - 1) / per,
        [&](int t, int u) {
          const int j = pos(t, u);
          return live && j < len ? col[beg + j] : -1;
        },
        [&](Slot* slot, int r) {
          if constexpr (kRecord) {   // dv == 1, a lane a group
            const int rp = __shfl_xor_sync(kFull, r, 1);
            const int half = lane & 1, pair = lane & ~1;
#pragma unroll
            for (int i = 0; i < 2; ++i) {   // lane pair + i's edge
              const int ri = half == i ? r : rp;
              if (ri >= 0)
                cp_async16(half ? static_cast<void*>(&slot->st[pair + i])
                                : static_cast<void*>(&slot->a[0][pair + i]),
                           stats + 2 * ((long long)ri * heads + h) + half);
            }
            if (r >= 0)
              cp_async(&slot->b[0][lane], dy + (long long)r * heads + h);
          } else {
            if (r < 0) return;
            const long long rh = (long long)r * heads + h;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const int f = sub + c * g;
              if (f < dv) {
                cp_async(&slot->a[c][lane], q + rh * dv + f);
                cp_async(&slot->b[c][lane], dy + rh * dv + f);
              }
            }
            cp_async(&slot->st[lane], stats + rh);
          }
        },
        [&](int t, const Slot* slot) {
          float plg[U], pvd[U];
          bool ok[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            ok[u] = live && pos(t, u) < len;
            plg[u] = 0.f;
            pvd[u] = 0.f;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const int f = sub + c * g;
              if (ok[u] && f < dv) {
                const A kc = widen(k_at(c));
                const A raw = vadd(widen(slot[u].a[c][lane]), kc);
                plg[u] += vdot(a_at(c), lrelu(raw, slope));
                pvd[u] += vdot(kc, widen(slot[u].b[c][lane]));
              }
            }
          }
          for (int off = 1; off < g; off <<= 1) {   // the group's G lanes
#pragma unroll
            for (int u = 0; u < U; ++u) {
              plg[u] += __shfl_xor_sync(kFull, plg[u], off);
              pvd[u] += __shfl_xor_sync(kFull, pvd[u], off);
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (!ok[u]) continue;
            const float4 st = slot[u].st[lane];   // mx, den, s_n
            const float alpha = expf(plg[u] - st.x) / st.y;
            const float dlg = alpha * (pvd[u] - st.z);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const int f = sub + c * g;
              if (f < dv) {
                const A raw =
                    vadd(widen(slot[u].a[c][lane]), widen(k_at(c)));
                axpy_dlrelu(acc[c], dlg, a_at(c), raw, slope);
                axpy(acc[c], alpha, widen(slot[u].b[c][lane]));
              }
            }
          }
        });
    // the groups' lanes of one vector are G apart, within the row's lanes
    for (int off = g; off < S.seg; off <<= 1) {
#pragma unroll
      for (int c = 0; c < NC; ++c) add_xor(acc[c], off);
    }
    if (live && S.grp == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int f = sub + c * g;
        if (f < dv) st_cs(dk + sh * dv + f, narrow<V>(acc[c]));
      }
    }
  });
}

// K10, replacing _gatv2_bwd_fwd_kernel. Over the receiver CSR, row r, head
// h, with alpha_e and dlg_e as in K11:
//   dq[r] = sum_e dlg_e * a * lrelu'(raw_e),   da[:, h] += sum_e dlg_e * act_e
// K9's receiver walk in K8's rows: heads in the grid's second dimension, so
// the resident warps gather one head's slice of k (16 MB at N = 131,072, H
// = 4, O = 32, which the L2 holds); R rows per warp, the window of sender
// indices loaded ahead, the hub switch (walk_rows); each row's q, dy, mx,
// den and s_n loaded once before its edges; each group loads U edges' k
// rows before it reduces any of their dots, and reduces the 2U dots in one
// shuffle tree. a, dq and this warp's share of da stay in registers. da
// with no atomics: the block's 8 warps (all of head h) put their shares in
// shared memory, and the block adds them in warp order and writes one
// partial per entry to da_part [H, O, blocks], the blocks of a head side
// by side for gatv2_da_reduce_kernel to read in order. The first port gave
// a (row, head) pair a warp in a persistent grid, heads interleaved, and
// waited on col[e], then the k row, then the tree, one edge at a time.
// V, the rows' storage vector, as K9's; da's shares stay float32.
template <typename V, int NC, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
gatv2_bwd_dq_kernel(const int* __restrict__ indptr,
                    const int* __restrict__ col, const V* __restrict__ q,
                    const V* __restrict__ k, const float* __restrict__ a,
                    const float* __restrict__ mx,
                    const float* __restrict__ den,
                    const float* __restrict__ s_n, const V* __restrict__ dy,
                    V* __restrict__ dq, float* __restrict__ da_part,
                    int n_rows, int heads, int dv, int log_g, int log_rows,
                    float slope) {
  extern __shared__ float da_warps[];        // [8 warps][O floats]
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;                  // lanes per edge group
  const int sub = lane & (g - 1);
  const int h = blockIdx.y;
  using A = Acc<V>;
  A av[NC], dav[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int f = sub + c * g;
    av[c] = f < dv ? load_a<A>(a, f, heads, h) : vzero<A>();
    dav[c] = vzero<A>();
  }
  const int rb = row_block(n_rows, log_rows);
  if (rb >= 0) {                    // warp-uniform; every warp meets below
    walk_rows(indptr, rb, lane, n_rows, log_rows,
              [&](int row, int beg, int len, int longest, int log_seg) {
      const Seg S(lane, log_seg, log_g);
      const bool live = row < n_rows;
      const long long rh = (long long)row * heads + h;
      A qv[NC], dyv[NC], dqa[NC];
      // q, dy and dq stream past the L2 (evict-first), which keeps the
      // head's slice of k that the pass gathers from
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int f = sub + c * g;
        qv[c] = live && f < dv ? widen(ld_cs(q + rh * dv + f)) : vzero<A>();
        dyv[c] = live && f < dv ? widen(ld_cs(dy + rh * dv + f)) : vzero<A>();
        dqa[c] = vzero<A>();
      }
      const float mxr = live ? mx[rh] : 0.f, denr = live ? den[rh] : 1.f;
      const float snr = live ? s_n[rh] : 0.f;
      int c = S.sl < len ? col[beg + S.sl] : 0;   // the first window
      for (int w0 = 0; w0 < longest; w0 += S.seg) {   // warp-uniform trips
        const int nc =
            w0 + S.seg + S.sl < len ? col[beg + w0 + S.seg + S.sl] : 0;
        const int cnt = min(S.seg, longest - w0);
        for (int j0 = 0; j0 < cnt; j0 += S.p * U) {   // warp-uniform trips
          V kg[U][NC];
          A raw[U][NC];
          float plg[U], pvd[U];
          bool ok[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {   // the gathers of U edges first
            const int j = S.pos(j0, u);
            const int src = __shfl_sync(kFull, c, S.holder(j));
            ok[u] = live && j < S.seg && w0 + j < len;
            const long long sh = (long long)src * heads + h;
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
              const int f = sub + cc * g;
              kg[u][cc] = ok[u] && f < dv ? k[sh * dv + f] : vzero<V>();
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            plg[u] = 0.f;
            pvd[u] = 0.f;
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
              const A kw = widen(kg[u][cc]);
              pvd[u] += vdot(kw, dyv[cc]);
              raw[u][cc] = vadd(qv[cc], kw);
              plg[u] += vdot(av[cc], lrelu(raw[u][cc], slope));
            }
          }
          for (int off = 1; off < g; off <<= 1) {   // the group's G lanes
#pragma unroll
            for (int u = 0; u < U; ++u) {
              plg[u] += __shfl_xor_sync(kFull, plg[u], off);
              pvd[u] += __shfl_xor_sync(kFull, pvd[u], off);
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (!ok[u]) continue;
            const float alpha = expf(plg[u] - mxr) / denr;
            const float dlg = alpha * (pvd[u] - snr);
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
              axpy_dlrelu(dqa[cc], dlg, av[cc], raw[u][cc], slope);
              axpy(dav[cc], dlg, lrelu(raw[u][cc], slope));
            }
          }
        }
        c = nc;
      }
      // the groups' lanes of one vector are G apart, within the row's lanes
      for (int off = g; off < S.seg; off <<= 1) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) add_xor(dqa[cc], off);
      }
      if (live && S.grp == 0) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int f = sub + cc * g;
          if (f < dv) st_cs(dq + rh * dv + f, narrow<V>(dqa[cc]));
        }
      }
    });
  }
  // this warp's share of da[:, h]: the lanes of one vector are G apart
  for (int off = g; off < 32; off <<= 1) {
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) add_xor(dav[cc], off);
  }
  A* mine = reinterpret_cast<A*>(da_warps) + (threadIdx.x >> 5) * dv;
  if (lane < g) {
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int f = sub + cc * g;
      if (f < dv) mine[f] = dav[cc];
    }
  }
  __syncthreads();
  const int o = dv * (int)(sizeof(A) / sizeof(float));
  for (int f = threadIdx.x; f < o; f += kThreads) {   // the warps in order
    float t = 0.f;
    for (int w = 0; w < kWarpsPerBlock; ++w) t += da_warps[w * o + f];
    da_part[((long long)h * o + f) * gridDim.x + blockIdx.x] = t;
  }
}

// K10's second launch: da[f, h] = the sum over blocks b of da_part[h, f, b].
// One block per entry: thread t adds b = t, t + 256, ... in order, a fixed
// shuffle tree adds each warp's lanes, and thread 0 the 8 warps in order:
// the same bits in every run.
__global__ void __launch_bounds__(kThreads)
gatv2_da_reduce_kernel(const float* __restrict__ da_part,
                       float* __restrict__ da, int blocks, int heads, int o) {
  __shared__ float warp_sums[kWarpsPerBlock];
  const int f = blockIdx.x, h = blockIdx.y;
  const float* p = da_part + ((long long)h * o + f) * blocks;
  float acc = 0.f;
  for (int b = threadIdx.x; b < blocks; b += kThreads) acc += p[b];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarpsPerBlock; ++w) t += warp_sums[w];
    da[(long long)f * heads + h] = t;
  }
}

// K5, replacing _gat_bwd_rev_kernel. Over the sender CSR, row s (col holds
// the receivers r_e), head h:
//   alpha_e = exp(lrelu(raw_e) - mx[r]) / den[r],  raw_e = pi[r] + pj[s]
//   dv[s]  = sum_e alpha_e * dy[r_e]
//   dpj[s] = sum_e alpha_e * (<v[s], dy[r_e]> - s_n[r_e]) * lrelu'(raw_e)
// K8's sender walk with a scalar logit: heads in the grid's second
// dimension, so the resident warps gather one head's slice of dy (16 MB at
// N = 131,072, H = 4, D = 32); R rows per warp, the window of receiver
// indices loaded ahead, the hub switch (walk_rows); each group loads U
// edges' receiver scalars and dy rows before it uses any of them. v[s]
// stays in registers; each lane adds w_e * (its share of <v[s], dy[r_e]>)
// to its own partial of dpj, with no shuffle per edge, and one fixed tree
// over the row's lanes closes it. With stats, each receiver's (pi, mx, den,
// s_n) come packed as one float4 [rows, H, 4]: one 16-byte load an edge in
// place of four 4-byte ones. Rows wider than NC * G vectors (256 at most)
// take passes of NC * G vectors, each walking the row's edges again. V, the
// rows' storage vector, as K3's: bfloat16 rows, pi, pj and dpj, float32
// mx, den, s_n and stats, float32 sums, dv and dpj rounded once.
template <typename V, int NC, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
gat_bwd_rev_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                   const Scalar<V>* __restrict__ pi,
                   const Scalar<V>* __restrict__ pj, const V* __restrict__ v,
                   const float* __restrict__ mx,
                   const float* __restrict__ den,
                   const float* __restrict__ s_n,
                   const float4* __restrict__ stats, const V* __restrict__ dy,
                   Scalar<V>* __restrict__ dpj, V* __restrict__ dv_out,
                   int n_rows, int heads, int dv, int log_g, int log_rows,
                   float slope) {
  const int rb = row_block(n_rows, log_rows);
  if (rb < 0) return;                        // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;                  // lanes per edge group
  const int sub = lane & (g - 1);
  const int h = blockIdx.y;
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_g);
    const bool live = row < n_rows;
    const long long sh = (long long)row * heads + h;
    const float pjs = live ? ldf(pj + sh) : 0.f;
    float acc_pj = 0.f;   // this lane's share of dpj[s]
    // at least one pass, so that dpj is summed when D == 0
    for (int f0 = 0; f0 == 0 || f0 < dv; f0 += NC * g) {
      Acc<V> vs[NC], acc[NC];
      // v and dv stream past the L2 (evict-first), which keeps the head's
      // slice of dy that the pass gathers from
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int f = f0 + sub + c * g;
        vs[c] = live && f < dv ? widen(ld_cs(v + sh * dv + f))
                               : vzero<Acc<V>>();
        acc[c] = vzero<Acc<V>>();
      }
      int c = S.sl < len ? col[beg + S.sl] : 0;   // the first window
      for (int w0 = 0; w0 < longest; w0 += S.seg) {   // warp-uniform trips
        const int nc =
            w0 + S.seg + S.sl < len ? col[beg + w0 + S.seg + S.sl] : 0;
        const int cnt = min(S.seg, longest - w0);
        for (int j0 = 0; j0 < cnt; j0 += S.p * U) {   // warp-uniform trips
          V dyg[U][NC];
          float pir[U], mxr[U], denr[U], snr[U];
          bool ok[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {   // the loads of U edges first
            const int j = S.pos(j0, u);
            const int r = __shfl_sync(kFull, c, S.holder(j));
            ok[u] = live && j < S.seg && w0 + j < len;
            const long long rh = (long long)r * heads + h;
            if (stats) {   // one 16-byte load for the four (uniform)
              const float4 st =
                  ok[u] ? stats[rh] : make_float4(0.f, 0.f, 1.f, 0.f);
              pir[u] = st.x;
              mxr[u] = st.y;
              denr[u] = st.z;
              snr[u] = st.w;
            } else {
              pir[u] = ok[u] ? ldf(pi + rh) : 0.f;
              mxr[u] = ok[u] ? mx[rh] : 0.f;
              denr[u] = ok[u] ? den[rh] : 1.f;
              snr[u] = ok[u] ? s_n[rh] : 0.f;
            }
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
              const int f = f0 + sub + cc * g;
              dyg[u][cc] = ok[u] && f < dv ? dy[rh * dv + f] : vzero<V>();
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (!ok[u]) continue;
            const float raw = pir[u] + pjs;
            const float alpha = expf(lrelu(raw, slope) - mxr[u]) / denr[u];
            const float w = alpha * dlrelu(raw, slope);
            float part = 0.f;
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
              const Acc<V> d = widen(dyg[u][cc]);
              axpy(acc[cc], alpha, d);
              part += vdot(vs[cc], d);
            }
            acc_pj = fmaf(w, part, acc_pj);
            if (f0 == 0 && sub == 0) acc_pj -= w * snr[u];   // once an edge
          }
        }
        c = nc;
      }
      // the groups' lanes of one vector are G apart, within the row's lanes
      for (int off = g; off < S.seg; off <<= 1) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) add_xor(acc[cc], off);
      }
      if (live && S.grp == 0) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int f = f0 + sub + cc * g;
          if (f < dv) st_cs(dv_out + sh * dv + f, narrow<V>(acc[cc]));
        }
      }
    }
    for (int off = 1; off < S.seg; off <<= 1)   // the row's lanes
      acc_pj += __shfl_xor_sync(kFull, acc_pj, off);
    if (live && S.sl == 0) stf(dpj + sh, acc_pj);
  });
}

// K9 in rows, replacing _flash_gatv2_kernel. Over the receiver CSR, row r,
// head h:
//   m = max_e lg_e,  s = sum_e exp(lg_e - m),  num = sum_e exp(lg_e - m) k[s_e]
// with lg_e = <a[:, h], lrelu(q[r] + k[s_e])>, and m = -inf, s = 0, num = 0
// for a row without edges or whose logits are all -inf. K10's receiver walk
// in K8's rows: heads in the grid's second dimension, so the resident warps
// gather one head's slice of k (16 MB at N = 131,072, H = 4, O = 32, which
// the L2 holds); R rows per warp, the window of sender indices loaded
// ahead, the hub switch (walk_rows). Each group issues U edges' k rows
// before it reduces any of them, and the U partial logits go through one
// interleaved shuffle tree. The softmax is K6's one pass: the batch's max
// first, one rescale, then the U edges added in CSR order; the row's groups
// merge by a fixed tree. Each k row is the logit's operand and the value
// both, so an edge is one gather. a[:, h] and q[r] stay in registers; q and
// num stream past the L2 (evict-first). The first port gave a (row, head)
// pair a warp, heads side by side, and waited on col[e], then the k row,
// then the tree, then the exp, one edge at a time.
//
// V is the rows' storage vector (vec.cuh): float4 or float, or for
// bfloat16 q, k and num bf16x8, bf16x4 or bf16x1 (K10 and K11 the same,
// with dy, dq and dk). a is float32 (the wrapper widens a bfloat16 a,
// exactly). q[r], a and the sums are kept in the sum type Acc<V>, each
// gathered row widened where it is used: raw, act, the logit, the softmax
// state and every sum are float32, and each bfloat16 output row is rounded
// once when stored. Every instance holds a row in NC register chunks of 32
// vectors, as the float32 ones (the logit needs the whole row: no passes).
template <typename V, int NC, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
gatv2_softmax_rows_kernel(const int* __restrict__ indptr,
                          const int* __restrict__ col, const V* __restrict__ q,
                          const V* __restrict__ k, const float* __restrict__ a,
                          V* __restrict__ num, float* __restrict__ m,
                          float* __restrict__ s, int n_rows, int heads,
                          int dv, int log_g, int log_rows, float slope) {
  const int rb = row_block(n_rows, log_rows);
  if (rb < 0) return;                        // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;                  // lanes per edge group
  const int sub = lane & (g - 1);
  const int h = blockIdx.y;
  using A = Acc<V>;
  A av[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int f = sub + c * g;
    av[c] = f < dv ? load_a<A>(a, f, heads, h) : vzero<A>();
  }
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_g);
    const bool live = row < n_rows;
    const long long rh = (long long)row * heads + h;
    A qv[NC], acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = sub + c * g;
      qv[c] = live && f < dv ? widen(ld_cs(q + rh * dv + f)) : vzero<A>();
      acc[c] = vzero<A>();
    }
    float mg = -INFINITY, sg = 0.f;   // this edge group's running max and sum
    int c = S.sl < len ? col[beg + S.sl] : 0;   // the first window
    for (int w0 = 0; w0 < longest; w0 += S.seg) {   // warp-uniform trips
      const int nc =
          w0 + S.seg + S.sl < len ? col[beg + w0 + S.seg + S.sl] : 0;
      const int cnt = min(S.seg, longest - w0);
      for (int j0 = 0; j0 < cnt; j0 += S.p * U) {   // warp-uniform trips
        V kg[U][NC];
        float lg[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {   // the gathers of U edges first
          const int j = S.pos(j0, u);
          const int src = __shfl_sync(kFull, c, S.holder(j));
          ok[u] = live && j < S.seg && w0 + j < len;
          const long long sh = (long long)src * heads + h;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) {
            const int f = sub + cc * g;
            kg[u][cc] = ok[u] && f < dv ? k[sh * dv + f] : vzero<V>();
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          lg[u] = 0.f;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc)
            lg[u] +=
                vdot(av[cc], lrelu(vadd(qv[cc], widen(kg[u][cc])), slope));
        }
        for (int off = 1; off < g; off <<= 1) {   // the group's G lanes
#pragma unroll
          for (int u = 0; u < U; ++u)
            lg[u] += __shfl_xor_sync(kFull, lg[u], off);
        }
        // the batch's max first, so that the group rescales once and the
        // U exps do not wait on each other
        float bm = mg;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          lg[u] = ok[u] ? lg[u] : -INFINITY;
          bm = fmaxf(bm, lg[u]);
        }
        if (bm > mg) {
          const float sc = expf(mg - bm);   // 0 while mg is -inf
          sg *= sc;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc) vscale(acc[cc], sc);
          mg = bm;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float pe = lg[u] == -INFINITY ? 0.f : expf(lg[u] - mg);
          sg += pe;
#pragma unroll
          for (int cc = 0; cc < NC; ++cc)
            axpy(acc[cc], pe, widen(kg[u][cc]));
        }
      }
      c = nc;
    }
    // merge the row's groups (G lanes apart): rescale each to the row max,
    // then add
    float mx = mg;
    for (int off = g; off < S.seg; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    const float sc = mg == -INFINITY ? 0.f : expf(mg - mx);
    sg *= sc;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) vscale(acc[cc], sc);
    for (int off = g; off < S.seg; off <<= 1) {
      sg += __shfl_xor_sync(kFull, sg, off);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) add_xor(acc[cc], off);
    }
    if (live && S.grp == 0) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int f = sub + cc * g;
        if (f < dv) st_cs(num + rh * dv + f, narrow<V>(acc[cc]));
      }
    }
    if (live && S.sl == 0) {
      m[rh] = mx;
      s[rh] = sg;
    }
  });
}

// K3 in rows, replacing _flash_gat_kernel. Over the receiver CSR, row r,
// head h, with the scalar logit lg_e = lrelu(pi[r, h] + pj[s_e, h]):
//   m = max_e lg_e,  s = sum_e exp(lg_e - m),  num = sum_e exp(lg_e - m) v[s_e]
// with m = -inf, s = 0, num = 0 for a row without edges or whose logits are
// all -inf. K6's rows with a scalar logit: heads in the grid's second
// dimension, so the resident warps gather one head's slice of v (16 MB at
// N = 131,072, H = 4, D = 32); R rows per warp, the window of sender
// indices loaded ahead, the hub switch (walk_rows); each group issues U
// edges' v rows before it adds any of them, and the softmax is K6's one
// pass (the batch's max first, one rescale, the edges added in CSR order,
// the row's groups merged by a fixed tree). pi[r, h] stays in a register;
// each edge gathers one v row and one pj scalar. With ahead, the lane that
// holds an edge's index loads its pj one window ahead (the indices two
// windows ahead) and hands the scalar along with the index; without it,
// every lane of the group loads pj beside the v row. Rows wider than NC * G
// vectors (256 at most) take passes of NC * G vectors; each pass walks the
// row again and rebuilds the same m and s, bit for bit, and the first pass
// writes them. num streams past the L2 (evict-first). The first port gave a
// (row, head) pair a warp, heads side by side, and took two passes over a
// row's edges, gathering each pj twice.
//
// V is the rows' storage vector (vec.cuh): float4 or float, or for
// bfloat16 values bf16x8, bf16x4 or bf16x1, with bfloat16 pi and pj. The
// logits, the softmax state (m, s) and the sums are float32, each gathered
// row widened where it is added; num is rounded once when stored. The
// bfloat16 instances hold one register chunk (NC = 1): wider rows take
// passes of 32 vectors.
template <typename V, int NC, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
gat_softmax_rows_kernel(const int* __restrict__ indptr,
                        const int* __restrict__ col,
                        const Scalar<V>* __restrict__ pi,
                        const Scalar<V>* __restrict__ pj,
                        const V* __restrict__ v, V* __restrict__ num,
                        float* __restrict__ m,
                        float* __restrict__ s, int n_rows, int heads, int dv,
                        int log_g, int log_rows, int ahead, float slope) {
  const int rb = row_block(n_rows, log_rows);
  if (rb < 0) return;                        // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;                  // lanes per edge group
  const int sub = lane & (g - 1);
  const int h = blockIdx.y;
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_g);
    const bool live = row < n_rows;
    const long long rh = (long long)row * heads + h;
    const float pir = live ? ldf(pi + rh) : 0.f;
    // at least one pass, so that s is summed when D == 0
    for (int f0 = 0; f0 == 0 || f0 < dv; f0 += NC * g) {
      Acc<V> acc[NC];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) acc[cc] = vzero<Acc<V>>();
      float mg = -INFINITY, sg = 0.f;   // this edge group's running max, sum
      // this lane's index of the window, of the next one (ahead), and the
      // pj of its edge of the window (ahead)
      int c = S.sl < len ? col[beg + S.sl] : 0;
      int nc = ahead && S.seg + S.sl < len ? col[beg + S.seg + S.sl] : 0;
      float pc = ahead && S.sl < len ? ldf(pj + (long long)c * heads + h)
                                     : 0.f;
      for (int w0 = 0; w0 < longest; w0 += S.seg) {   // warp-uniform trips
        int nn;
        float npc = 0.f;
        if (ahead) {   // indices two windows ahead, pj one
          const int j2 = w0 + 2 * S.seg + S.sl;
          nn = j2 < len ? col[beg + j2] : 0;
          if (w0 + S.seg + S.sl < len)
            npc = ldf(pj + (long long)nc * heads + h);
        } else {
          const int j1 = w0 + S.seg + S.sl;
          nn = j1 < len ? col[beg + j1] : 0;
        }
        const int cnt = min(S.seg, longest - w0);
        for (int j0 = 0; j0 < cnt; j0 += S.p * U) {   // warp-uniform trips
          V vg[U][NC];
          float lg[U];
          bool ok[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {   // the gathers of U edges first
            const int j = S.pos(j0, u);
            const int src = __shfl_sync(kFull, c, S.holder(j));
            ok[u] = live && j < S.seg && w0 + j < len;
            const long long sh = (long long)src * heads + h;
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
              const int f = f0 + sub + cc * g;
              vg[u][cc] = ok[u] && f < dv ? v[sh * dv + f] : vzero<V>();
            }
            if (!ahead) lg[u] = ok[u] ? ldf(pj + sh) : 0.f;
          }
          if (ahead) {
#pragma unroll
            for (int u = 0; u < U; ++u)
              lg[u] = __shfl_sync(kFull, pc, S.holder(S.pos(j0, u)));
          }
          // the batch's max first, so that the group rescales once and the
          // U exps do not wait on each other
          float bm = mg;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            lg[u] = ok[u] ? lrelu(pir + lg[u], slope) : -INFINITY;
            bm = fmaxf(bm, lg[u]);
          }
          if (bm > mg) {
            const float sc = expf(mg - bm);   // 0 while mg is -inf
            sg *= sc;
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) vscale(acc[cc], sc);
            mg = bm;
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float pe = lg[u] == -INFINITY ? 0.f : expf(lg[u] - mg);
            sg += pe;
#pragma unroll
            for (int cc = 0; cc < NC; ++cc)
              axpy(acc[cc], pe, widen(vg[u][cc]));
          }
        }
        if (ahead) {
          c = nc;
          nc = nn;
          pc = npc;
        } else {
          c = nn;
        }
      }
      // merge the row's groups (G lanes apart): rescale each to the row
      // max, then add
      float mx = mg;
      for (int off = g; off < S.seg; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float sc = mg == -INFINITY ? 0.f : expf(mg - mx);
      sg *= sc;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) vscale(acc[cc], sc);
      for (int off = g; off < S.seg; off <<= 1) {
        sg += __shfl_xor_sync(kFull, sg, off);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) add_xor(acc[cc], off);
      }
      if (live && S.grp == 0) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int f = f0 + sub + cc * g;
          if (f < dv) st_cs(num + rh * dv + f, narrow<V>(acc[cc]));
        }
      }
      if (live && S.sl == 0 && f0 == 0) {
        m[rh] = mx;
        s[rh] = sg;
      }
    }
  });
}

// K12 in rows, replacing _flash_kernel. Over the receiver CSR, row r, head
// h, with the given logits lg[e, h]:
//   m = max_e lg_e,  s = sum_e exp(lg_e - m),
//   num = sum_e exp(lg_e - m) * mask[e, h] * v_e
// with v_e = v[col[e]] (node values) or v[e] (edge values, col == NULL),
// mask == NULL all ones, and m = -inf, s = 0, num = 0 for a row without
// edges or whose logits are all -inf. K3's rows and one-pass softmax: R
// rows per warp, the hub switch (walk_rows); each group issues U edges'
// value rows before it adds any of them. Edges are stored sorted by
// receiver, so lg and mask are read by CSR position, as col is: the lane
// that loads an edge's index loads its logit and mask with it, a window
// ahead, and hands the three to the group by shuffle. Heads go in the
// grid's second dimension, so the resident warps gather one head's slice
// of v (16 MB at N = 131,072, H = 4, D = 32). lg and mask are then read
// in place, with a stride of H floats (head-major copies, their transposes
// timed with the call, were slower). With interleave, block b takes head
// b mod H of row block b / H instead: the blocks that run together read
// every head of the same edges, which suits edge values, streamed rather
// than gathered. The per-edge scalars and edge values stream past the L2
// (evict-first), and so does num. Rows wider than NC * G vectors (256 at
// most) take passes of NC * G vectors; each pass walks the row again and
// rebuilds the same m and s, bit for bit, and the first pass writes them.
// The first port gave a (row, head) pair a warp, heads side by side, and
// took two passes over a row's edges, each edge waiting on its index
// before its value row.
//
// V is the values' storage vector, as K3's: bfloat16 values take bfloat16
// logits and mask, widened to float where they are read; m, s and the
// sums stay float32 and num is rounded once when stored (the TPU kernel
// rounds its numerator at every 512-edge block). The bfloat16 instances
// hold one register chunk (NC = 1): wider rows take passes of 32 vectors.
template <typename V, int NC, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
edge_softmax_rows_kernel(const int* __restrict__ indptr,
                         const int* __restrict__ col,
                         const Scalar<V>* __restrict__ lg,
                         const Scalar<V>* __restrict__ mask,
                         const V* __restrict__ v, V* __restrict__ num,
                         float* __restrict__ m, float* __restrict__ s,
                         int n_rows, int heads, int dv, int log_g,
                         int log_rows, int interleave) {
  const int h = interleave ? blockIdx.x % heads : blockIdx.y;
  const int xb = interleave ? blockIdx.x / heads : blockIdx.x;
  const int rb = xb * kWarpsPerBlock + (threadIdx.x >> 5);
  if (rb >= ((n_rows + (1 << log_rows) - 1) >> log_rows)) return;  // uniform
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;                  // lanes per edge group
  const int sub = lane & (g - 1);
  // head h's logit and mask of edge e: at e * heads from lg_h and mask_h
  const Scalar<V>* lg_h = lg + h;
  const Scalar<V>* mask_h = mask ? mask + h : nullptr;
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_g);
    const bool live = row < n_rows;
    const long long rh = (long long)row * heads + h;
    // lane sl holds window position w0 + sl: its sender, logit and mask
    auto fetch = [&](int w0, int& c, float& l, float& k) {
      const int j = w0 + S.sl;
      const long long e = (long long)beg + j;
      c = col && j < len ? col[e] : 0;
      l = j < len ? widen(ld_cs(lg_h + e * heads)) : -INFINITY;
      k = mask_h && j < len ? widen(ld_cs(mask_h + e * heads)) : 1.f;
    };
    // at least one pass, so that s is summed when D == 0
    for (int f0 = 0; f0 == 0 || f0 < dv; f0 += NC * g) {
      Acc<V> acc[NC];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) acc[cc] = vzero<Acc<V>>();
      float mg = -INFINITY, sg = 0.f;   // this edge group's running max, sum
      int c, nc;
      float l, nl, k, nk;
      fetch(0, c, l, k);
      for (int w0 = 0; w0 < longest; w0 += S.seg) {   // warp-uniform trips
        fetch(w0 + S.seg, nc, nl, nk);                // the next window, ahead
        const int cnt = min(S.seg, longest - w0);
        for (int j0 = 0; j0 < cnt; j0 += S.p * U) {   // warp-uniform trips
          V vg[U][NC];
          float le[U], mk[U];
          bool ok[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {   // the loads of U edges first
            const int j = S.pos(j0, u);
            const int hold = S.holder(j);
            // col and mask are uniform over the grid
            const int src = col ? __shfl_sync(kFull, c, hold) : beg + w0 + j;
            le[u] = __shfl_sync(kFull, l, hold);
            mk[u] = mask_h ? __shfl_sync(kFull, k, hold) : 1.f;
            ok[u] = live && j < S.seg && w0 + j < len;
            const long long sh = (long long)src * heads + h;
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
              const int f = f0 + sub + cc * g;
              if (!ok[u] || f >= dv)
                vg[u][cc] = vzero<V>();
              else
                vg[u][cc] = col ? v[sh * dv + f] : ld_cs(v + sh * dv + f);
            }
          }
          // the batch's max first, so that the group rescales once and the
          // U exps do not wait on each other
          float bm = mg;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            le[u] = ok[u] ? le[u] : -INFINITY;
            bm = fmaxf(bm, le[u]);
          }
          if (bm > mg) {
            const float sc = expf(mg - bm);   // 0 while mg is -inf
            sg *= sc;
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) vscale(acc[cc], sc);
            mg = bm;
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float pe = le[u] == -INFINITY ? 0.f : expf(le[u] - mg);
            sg += pe;
            const float w = pe * mk[u];
#pragma unroll
            for (int cc = 0; cc < NC; ++cc)
              axpy(acc[cc], w, widen(vg[u][cc]));
          }
        }
        c = nc;
        l = nl;
        k = nk;
      }
      // merge the row's groups (G lanes apart): rescale each to the row
      // max, then add
      float mx = mg;
      for (int off = g; off < S.seg; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float sc = mg == -INFINITY ? 0.f : expf(mg - mx);
      sg *= sc;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) vscale(acc[cc], sc);
      for (int off = g; off < S.seg; off <<= 1) {
        sg += __shfl_xor_sync(kFull, sg, off);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) add_xor(acc[cc], off);
      }
      if (live && S.grp == 0) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int f = f0 + sub + cc * g;
          if (f < dv) st_cs(num + rh * dv + f, narrow<V>(acc[cc]));
        }
      }
      if (live && S.sl == 0 && f0 == 0) {
        m[rh] = mx;
        s[rh] = sg;
      }
    }
  });
}

// K4 in rows, replacing _gat_bwd_dpi_kernel. Over the receiver CSR, row r,
// head h:
//   alpha_e = exp(lrelu(raw_e) - mx[r]) / den[r],  raw_e = pi[r] + pj[s_e]
//   dpi[r]  = sum_e alpha_e * (<v[s_e], dy[r]> - s_n[r]) * lrelu'(raw_e)
// K3's receiver walk over the same gathers: heads in the grid's second
// dimension, so the resident warps gather one head's slice of v (16 MB at
// N = 131,072, H = 4, D = 32); R rows per warp, the window of sender
// indices loaded ahead, the hub switch (walk_rows); each group loads U
// edges' v rows and pj scalars before it uses any of them, pj by the lane
// holding the index one window ahead (ahead) or by every lane of the group
// beside the v row. dy[r] stays in registers (streamed past the L2), and
// the row's pi, mx, den and s_n are loaded once. Each lane adds w_e * (its
// share of <v[s_e], dy[r]>) to its own partial of dpi, with no shuffle per
// edge; one lane of the group subtracts w_e * s_n[r] once an edge, in the
// first pass; one fixed tree over the row's lanes closes the sum. Rows
// wider than NC * G vectors (256 at most) take passes of NC * G vectors,
// each walking the row's edges again. The first port gave a (row, head)
// pair a warp, heads side by side, shuffled each edge's index and weight
// to every lane, and regathered pj for every 32 vectors of a wide row. V,
// the rows' storage vector, as K3's: bfloat16 rows, pi, pj and dpi, float32
// mx, den and s_n, a float32 sum, dpi rounded once.
template <typename V, int NC, int U, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
gat_bwd_dpi_rows_kernel(const int* __restrict__ indptr,
                        const int* __restrict__ col,
                        const Scalar<V>* __restrict__ pi,
                        const Scalar<V>* __restrict__ pj,
                        const V* __restrict__ v, const float* __restrict__ mx,
                        const float* __restrict__ den,
                        const float* __restrict__ s_n,
                        const V* __restrict__ dy,
                        Scalar<V>* __restrict__ dpi,
                        int n_rows, int heads, int dv, int log_g,
                        int log_rows, int ahead, float slope) {
  const int rb = row_block(n_rows, log_rows);
  if (rb < 0) return;                        // warp-uniform
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;                  // lanes per edge group
  const int sub = lane & (g - 1);
  const int h = blockIdx.y;
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_g);
    const bool live = row < n_rows;
    const long long rh = (long long)row * heads + h;
    const float pir = live ? ldf(pi + rh) : 0.f, mxr = live ? mx[rh] : 0.f;
    const float denr = live ? den[rh] : 1.f, snr = live ? s_n[rh] : 0.f;
    float acc = 0.f;   // this lane's share of dpi[r]
    // at least one pass, so that dpi is summed when D == 0
    for (int f0 = 0; f0 == 0 || f0 < dv; f0 += NC * g) {
      Acc<V> dyv[NC];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int f = f0 + sub + cc * g;
        dyv[cc] = live && f < dv ? widen(ld_cs(dy + rh * dv + f))
                                 : vzero<Acc<V>>();
      }
      // this lane's index of the window, of the next one (ahead), and the
      // pj of its edge of the window (ahead)
      int c = S.sl < len ? col[beg + S.sl] : 0;
      int nc = ahead && S.seg + S.sl < len ? col[beg + S.seg + S.sl] : 0;
      float pc = ahead && S.sl < len ? ldf(pj + (long long)c * heads + h)
                                     : 0.f;
      for (int w0 = 0; w0 < longest; w0 += S.seg) {   // warp-uniform trips
        int nn;
        float npc = 0.f;
        if (ahead) {   // indices two windows ahead, pj one
          const int j2 = w0 + 2 * S.seg + S.sl;
          nn = j2 < len ? col[beg + j2] : 0;
          if (w0 + S.seg + S.sl < len)
            npc = ldf(pj + (long long)nc * heads + h);
        } else {
          const int j1 = w0 + S.seg + S.sl;
          nn = j1 < len ? col[beg + j1] : 0;
        }
        const int cnt = min(S.seg, longest - w0);
        for (int j0 = 0; j0 < cnt; j0 += S.p * U) {   // warp-uniform trips
          V vg[U][NC];
          float pje[U];
          bool ok[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {   // the loads of U edges first
            const int j = S.pos(j0, u);
            const int src = __shfl_sync(kFull, c, S.holder(j));
            ok[u] = live && j < S.seg && w0 + j < len;
            const long long sh = (long long)src * heads + h;
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
              const int f = f0 + sub + cc * g;
              vg[u][cc] = ok[u] && f < dv ? v[sh * dv + f] : vzero<V>();
            }
            if (!ahead) pje[u] = ok[u] ? ldf(pj + sh) : 0.f;
          }
          if (ahead) {
#pragma unroll
            for (int u = 0; u < U; ++u)
              pje[u] = __shfl_sync(kFull, pc, S.holder(S.pos(j0, u)));
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (!ok[u]) continue;
            const float raw = pir + pje[u];
            const float alpha = expf(lrelu(raw, slope) - mxr) / denr;
            const float w = alpha * dlrelu(raw, slope);
            float part = 0.f;
#pragma unroll
            for (int cc = 0; cc < NC; ++cc)
              part += vdot(widen(vg[u][cc]), dyv[cc]);
            acc = fmaf(w, part, acc);
            if (f0 == 0 && sub == 0) acc -= w * snr;   // once an edge
          }
        }
        if (ahead) {
          c = nc;
          nc = nn;
          pc = npc;
        } else {
          c = nn;
        }
      }
    }
    for (int off = 1; off < S.seg; off <<= 1)   // the row's lanes
      acc += __shfl_xor_sync(kFull, acc, off);
    if (live && S.sl == 0) stf(dpi + rh, acc);
  });
}

int log_group(int dv) {
  int lg = 0;
  while ((1 << lg) < dv && lg < 5) ++lg;
  return lg;
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The GATv2 kernels keep NC register chunks of 32 vectors per lane: calls
// f with std::integral_constant<int, NC> for the least NC in {1, 2, 4, 8}
// that holds dv vectors, and returns cudaGetLastError() after it, or
// cudaErrorInvalidValue (nothing launched) for rows wider than 256 vectors.
template <typename F>
int with_chunks(int dv, F&& f) {
  if (dv <= 32) {
    f(std::integral_constant<int, 1>{});
  } else if (dv <= 64) {
    f(std::integral_constant<int, 2>{});
  } else if (dv <= 128) {
    f(std::integral_constant<int, 4>{});
  } else if (dv <= 256) {
    f(std::integral_constant<int, 8>{});
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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

// The row kernels' instances (K6, K7 and K8 in rows). Calls go(nc, un,
// minb) for the instance of NC register chunks that holds `wide` vectors at
// U = unroll edges in flight and reg_cap (0: none; 64) where the library
// holds it, and returns cudaGetLastError() after it; cudaErrorInvalidValue,
// with nothing launched, where it does not or for rows wider than 256
// vectors. Built with GNN_SWEEP (the build chip_smoke.py --sweep times) the
// library holds U in {1, 2, 4} with NC * U <= 4 (U = 1 at every NC), each
// uncapped and, at NC <= 2, at 64 registers; the shipped library holds
// only the pairs for which Pick::holds(NC, U, cap), the ones the wrapper
// picks. With kPickOnly (the bfloat16 instances) only Pick's pairs, in
// either build, but for kSweepOneChunk (bfloat16 K6 rows, K7 rows and K8)
// the sweep build's pairs at NC = 1 too; with kOneChunk (the bfloat16 instances of
// K3, K4, K5 and K12) also only NC = 1 (rows of at most 32 vectors; the
// launcher takes wider rows in passes of 32).
template <typename Pick, bool kOneChunk = false,
          bool kPickOnly = kOneChunk, bool kSweepOneChunk = false,
          typename Go>
int with_row_instances(int wide, int unroll, int reg_cap, Go&& go) {
  if (kOneChunk && wide > 32) return static_cast<int>(cudaErrorInvalidValue);
  bool launched = false;
  const int rc = with_chunks(wide, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    auto pick = [&](auto un, auto cap) {
      constexpr int UU = decltype(un)::value, C = decltype(cap)::value;
#ifdef GNN_SWEEP
      constexpr bool sweep = true;
#else
      constexpr bool sweep = false;
#endif
      constexpr bool swept = (UU == 1 || NC * UU <= 4) && (C == 0 || NC <= 2);
      constexpr bool built =
          kPickOnly ? ((!kOneChunk || NC == 1) && Pick::holds(NC, UU, C)) ||
                          (sweep && kSweepOneChunk && NC == 1 && swept)
          : sweep   ? swept
                    : Pick::holds(NC, UU, C);
      if constexpr (built) {
        if (unroll == UU && reg_cap == C) {
          go(nc, un, MinBlocks<C>{});
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
  });
  if (rc != 0) return rc;
  return launched ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The strip kernels' instances: go(un, minb) at U = unroll and reg_cap
// where the library holds them (the sweep build: U in {1, 2, 4, 8}, each
// uncapped and at 64 registers; the shipped library, and with kPickOnly
// (the bfloat16 instances) either build: Pick::kUnroll at Pick::kCap).
// Returns cudaGetLastError() after it, or cudaErrorInvalidValue with
// nothing launched.
template <typename Pick, bool kPickOnly = false, typename Go>
int with_strip_instances(int unroll, int reg_cap, Go&& go) {
  bool launched = false;
  auto pick = [&](auto un, auto cap) {
    constexpr int UU = decltype(un)::value, C = decltype(cap)::value;
#ifdef GNN_SWEEP
    constexpr bool sweep = !kPickOnly;
#else
    constexpr bool sweep = false;
#endif
    constexpr bool built =
        sweep || (Pick::kUnroll == UU && Pick::kCap == C);
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
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The shipped instances, from chip_smoke.py --sweep (PERF.md §6), as
// ops/cuda/edge_softmax.py's _DOT_*, _K8_*, _K11_*, _K9_*, _K3_*, _K12_*
// and _K4_* constants pick them: rows of one register chunk take edges in
// flight at 64 registers (K8 and K11 2; K6, K7, K10, K5, K9, K3, K12 and
// K4 4 for groups of a 128-byte line or more; K6, K7, K10, K5, K12 and K4
// 2 for narrower ones, K9 2 uncapped, K3 1 uncapped), wider rows one edge,
// uncapped (two chunks of two edges at 64 registers spill); strips 4
// gathers in flight, uncapped.
struct K8Pick {
  static constexpr bool holds(int nc, int u, int cap) {
    return nc == 1 ? u == 2 && cap == 64 : u == 1 && cap == 0;
  }
};
struct K11Pick {
  static constexpr bool holds(int nc, int u, int cap) {
    return nc == 1 ? u == 2 && cap == 64 : u == 1 && cap == 0;
  }
};
struct RecvPick {
  static constexpr bool holds(int nc, int u, int cap) {
    return nc == 1 ? (u == 2 || u == 4) && cap == 64 : u == 1 && cap == 0;
  }
};
using K10Pick = RecvPick;
using K5Pick = RecvPick;
using K12Pick = RecvPick;
using K4Pick = RecvPick;
struct K9Pick {
  static constexpr bool holds(int nc, int u, int cap) {
    return nc == 1 ? (u == 4 && cap == 64) || (u == 2 && cap == 0)
                   : u == 1 && cap == 0;
  }
};
struct K3Pick {
  static constexpr bool holds(int nc, int u, int cap) {
    return nc == 1 ? (u == 4 && cap == 64) || (u == 1 && cap == 0)
                   : u == 1 && cap == 0;
  }
};
struct StripPick {
  static constexpr int kUnroll = 4;
  static constexpr int kCap = 0;
};
// bfloat16 K6's register instances on bf16x8 rows: RecvPick's and, at one
// register chunk, one edge in flight uncapped, which
// ops/cuda/edge_softmax.py's _K6_BF16 takes for rows of one vector (the
// fastest of chip_smoke.py --sweep bf16 there, PERF.md §6)
struct K6Bf16Pick {
  static constexpr bool holds(int nc, int u, int cap) {
    return RecvPick::holds(nc, u, cap) || (nc == 1 && u == 1 && cap == 0);
  }
};
template <typename V>
using K6RowPick =
    std::conditional_t<std::is_same<V, bf16x8>::value, K6Bf16Pick, RecvPick>;
// bfloat16 K7's register instances on bf16x8 rows, as
// ops/cuda/edge_softmax.py's _K7_BF16 takes them at one register chunk
// (the fastest of chip_smoke.py --sweep bf16_k7, PERF.md §6): one edge in
// flight at 64 registers for rows of one vector, two for wider ones; wider
// rows one edge, uncapped, up to 4 chunks (the 8-chunk instance spilled:
// wider heads take the strips). RecvPick's 4 edges at 64 registers spilled
// 88 bytes.
struct K7Bf16Pick {
  static constexpr bool holds(int nc, int u, int cap) {
    return nc == 1 ? (u == 1 || u == 2) && cap == 64
                   : nc <= 4 && u == 1 && cap == 0;
  }
};
template <typename V>
using K7RowPick =
    std::conditional_t<std::is_same<V, bf16x8>::value, K7Bf16Pick, RecvPick>;
// The staged bfloat16 K8's (edges a stage, stages, register cap) the
// shipped library holds at one register chunk, as
// ops/cuda/edge_softmax.py's _K8_BF16 picks them (the fastest of
// chip_smoke.py --sweep bf16 without a spill, PERF.md §6).
struct K8StagedPick {
  static constexpr bool holds(int u, int ns, int cap) {
    return (u == 1 && ns == 2 && cap == 0) || (u == 2 && ns == 2 && cap == 0);
  }
};
// The staged bfloat16 K11's, as ops/cuda/edge_softmax.py's _K11_BF16 picks
// them (the fastest of chip_smoke.py --sweep bf16_k11 without a spill,
// PERF.md §6).
struct K11StagedPick {
  static constexpr bool holds(int u, int ns, int cap) {
    return (u == 1 && ns == 2 && cap == 0) || (u == 2 && ns == 2 && cap == 0);
  }
};
// bfloat16 K8's register instances: K8Pick's, but on bf16x8 vectors, which
// the staged kernel takes at every width, none (the sweep build keeps its
// NC = 1 pairs: see with_row_instances)
struct NoPick {
  static constexpr bool holds(int, int, int) { return false; }
};
template <typename V>
using K8RegisterPick =
    std::conditional_t<std::is_same<V, bf16x8>::value, NoPick, K8Pick>;
// bfloat16 K11's register instances: K11Pick's, but on bf16x8 vectors, which
// the staged kernel takes at every width, none (it spilled; the sweep
// build keeps its NC = 1 pairs: see with_row_instances)
template <typename V>
using K11RegisterPick =
    std::conditional_t<std::is_same<V, bf16x8>::value, NoPick, K11Pick>;

// The staged K8's and K11's instances at NC register chunks: go(un, ns,
// minb) at U = unroll edges a stage, NS = stages and reg_cap where the
// library holds them (NC = 1: in the sweep build U in {1, 2}, NS in {2, 4,
// 6}, uncapped and at 64 registers, in the shipped library Pick's
// (K8StagedPick, K11StagedPick); wider rows: U = 1, NS = 2, uncapped, in
// either). Returns cudaGetLastError() after it, or cudaErrorInvalidValue
// with nothing launched.
template <typename Pick, int NC, typename Go>
int with_staged_instances(int unroll, int stages, int reg_cap, Go&& go) {
  bool launched = false;
  auto pick = [&](auto un, auto ns, auto cap) {
    constexpr int UU = decltype(un)::value, NS = decltype(ns)::value,
                  C = decltype(cap)::value;
#ifdef GNN_SWEEP
    constexpr bool sweep = true;
#else
    constexpr bool sweep = false;
#endif
    constexpr bool built = NC == 1 ? sweep || Pick::holds(UU, NS, C)
                                   : UU == 1 && NS == 2 && C == 0;
    if constexpr (built) {
      if (unroll == UU && stages == NS && reg_cap == C) {
        go(un, ns, MinBlocks<C>{});
        launched = true;
      }
    }
  };
  auto caps = [&](auto un, auto ns) {
    pick(un, ns, I0{});
    pick(un, ns, I64{});
  };
  using I6 = std::integral_constant<int, 6>;
  caps(I1{}, I2{});
  caps(I1{}, I4{});
  caps(I1{}, I6{});
  caps(I2{}, I2{});
  caps(I2{}, I4{});
  caps(I2{}, I6{});
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Launches a staged kernel with its ring of dynamic shared memory (above
// 48 KB asked for with cudaFuncSetAttribute; where that fails, nothing is
// launched and the error stays for cudaGetLastError).
template <typename Kernel, typename... Args>
void launch_staged(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st,
                   Args... args) {
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return;
  kernel<<<grid, kThreads, smem, st>>>(args...);
}

// Whether V is a bfloat16 storage vector, and the widest rows, in vectors,
// that its instances of K3, K4 and K5 hold in registers (passes beyond).
template <typename V>
constexpr bool kLow = !std::is_same<Acc<V>, V>::value;
template <typename V>
constexpr int kMaxWide = kLow<V> ? 32 : 256;

// log2 of the vectors of a strip, and the lanes of its edge groups: one
// 128-byte line (8 float4 or bf16x8, 16 bf16x4, 32 floats), or 32 single
// bfloat16 values (64 bytes: an edge group has at most 32 lanes).
template <typename V>
constexpr int log_line() {
  return sizeof(V) == 16 ? 3 : sizeof(V) == 8 ? 4 : 5;
}

// The grid of a row-walking pass: blocks of 8 warps of 2^log_rows rows
// each, by `columns` (heads, or heads times strips).
dim3 row_grid(int n_rows, int log_rows, int columns) {
  const int row_blocks = (n_rows + (1 << log_rows) - 1) >> log_rows;
  return dim3((row_blocks + kWarpsPerBlock - 1) / kWarpsPerBlock, columns);
}

// The layout checks shared by K6 and K7: whether log_rows rows of groups
// of 2^log_g lanes fit a warp and the grid's columns fit its second
// dimension.
bool dot_layout_ok(int log_g, int log_rows, long long columns) {
  return log_rows >= 0 && log_g + log_rows <= 5 && columns < 65536;
}

// K6 in rows or strips (see dot_softmax_rows_kernel and the strip
// passes), at the instances with_row_instances and with_strip_instances
// hold (bfloat16: only the shipped ones, in either build).
template <typename V>
int launch_dot_softmax(const int* indptr, const int* col, const void* q,
                       const void* k, const void* v, void* num, float* m,
                       float* s, float* raw, float* scratch, int n_rows,
                       int heads, int ov, int dv, long long n_edges,
                       int strips, int log_rows, int unroll, int reg_cap,
                       float scale, float slope, cudaStream_t st) {
  const V* qv = static_cast<const V*>(q);
  const V* kv = static_cast<const V*>(k);
  const V* vv = static_cast<const V*>(v);
  V* numv = static_cast<V*>(num);
  const int wide = ov > dv ? ov : dv;
  if (!strips) {
    const int lg = log_group(wide);
    if (!dot_layout_ok(lg, log_rows, heads))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid = row_grid(n_rows, log_rows, heads);
    return with_row_instances<K6RowPick<V>, false, kLow<V>, kLow<V>>(
        wide, unroll, reg_cap, [&](auto nc, auto un, auto minb) {
          dot_softmax_rows_kernel<V, decltype(nc)::value,
                                  decltype(un)::value, decltype(minb)::value>
              <<<grid, kThreads, 0, st>>>(indptr, col, qv, kv, vv, numv, m,
                                          s, raw, n_rows, heads, ov, dv, lg,
                                          log_rows, scale, slope);
        });
  }
  const int log_s = log_line<V>(), sv = 1 << log_s;
  const int ns_o = (ov + sv - 1) / sv, ns_d = (dv + sv - 1) / sv;
  const long long columns = (long long)heads * (ns_o > ns_d ? ns_o : ns_d);
  if ((n_edges > 0 && (raw == nullptr || scratch == nullptr)) || ov == 0 ||
      !dot_layout_ok(log_s, log_rows, columns))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part = scratch;
  float* w = scratch + (long long)heads * ns_o * n_edges;
  return with_strip_instances<StripPick, kLow<V>>(
      unroll, reg_cap, [&](auto un, auto minb) {
        constexpr int U = decltype(un)::value, MINB = decltype(minb)::value;
        dot_strip_dots_kernel<6, V, U, MINB>
            <<<row_grid(n_rows, log_rows, heads * ns_o), kThreads, 0, st>>>(
                indptr, col, qv, kv, part, n_rows, heads, ov, ns_o, n_edges,
                log_s, log_rows);
        dot_strip_stats_kernel<6>
            <<<row_grid(n_rows, 0, heads), kThreads, 0, st>>>(
                indptr, part, ns_o, nullptr, 0, raw, nullptr, nullptr,
                nullptr, w, m, s, n_rows, heads, n_edges, scale, slope);
        if (dv > 0)
          dot_strip_spmm_kernel<6, V, U, MINB>
              <<<row_grid(n_rows, log_rows, heads * ns_d), kThreads, 0,
                 st>>>(indptr, col, w, vv, numv, n_rows, heads, dv, ns_d,
                       n_edges, log_s, log_rows);
      });
}

// K7 in rows or strips (see dot_bwd_dq_rows_kernel and the strip
// passes), at the instances K6's launcher takes (bfloat16's rows
// K7Bf16Pick's on bf16x8 rows, and in the sweep build every pair of one
// register chunk).
template <typename V>
int launch_dot_bwd_dq(const int* indptr, const int* col, const void* q,
                      const void* k, const void* v, const float* mx,
                      const float* den, const float* s_n, const void* dy,
                      const float* raw, void* dq, float* scratch,
                      int n_rows, int heads, int ov, int dv,
                      long long n_edges, int strips, int log_rows, int unroll,
                      int reg_cap, float scale, float slope,
                      cudaStream_t st) {
  const V* qv = static_cast<const V*>(q);
  const V* kv = static_cast<const V*>(k);
  const V* vv = static_cast<const V*>(v);
  const V* dyv = static_cast<const V*>(dy);
  V* dqv = static_cast<V*>(dq);
  const int wide = ov > dv ? ov : dv;
  if (!strips) {
    const int lg = log_group(wide);
    if (!dot_layout_ok(lg, log_rows, heads))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid = row_grid(n_rows, log_rows, heads);
    return with_row_instances<K7RowPick<V>, false, kLow<V>, kLow<V>>(
        wide, unroll, reg_cap, [&](auto nc, auto un, auto minb) {
          dot_bwd_dq_rows_kernel<V, decltype(nc)::value, decltype(un)::value,
                                 decltype(minb)::value>
              <<<grid, kThreads, 0, st>>>(indptr, col, qv, kv, vv, mx, den,
                                          s_n, dyv, raw, dqv, n_rows, heads,
                                          ov, dv, lg, log_rows, scale, slope);
        });
  }
  const int log_s = log_line<V>(), sv = 1 << log_s;
  const int ns_o = (ov + sv - 1) / sv, ns_d = (dv + sv - 1) / sv;
  const long long columns = (long long)heads * (ns_o > ns_d ? ns_o : ns_d);
  if ((n_edges > 0 && scratch == nullptr) || ov == 0 ||
      !dot_layout_ok(log_s, log_rows, columns))
    return static_cast<int>(cudaErrorInvalidValue);
  // scratch: w [H, E], the partial <v, dy> [H, ns_d, E] and, with no
  // raw logits given, the partial logits [H, ns_o, E]
  float* w = scratch;
  float* part_vd = w + (long long)heads * n_edges;
  float* part_lg = part_vd + (long long)heads * ns_d * n_edges;
  return with_strip_instances<StripPick, kLow<V>>(
      unroll, reg_cap, [&](auto un, auto minb) {
        constexpr int U = decltype(un)::value, MINB = decltype(minb)::value;
        if (dv > 0)
          dot_strip_dots_kernel<7, V, U, MINB>
              <<<row_grid(n_rows, log_rows, heads * ns_d), kThreads, 0,
                 st>>>(indptr, col, dyv, vv, part_vd, n_rows, heads, dv,
                       ns_d, n_edges, log_s, log_rows);
        if (raw == nullptr)
          dot_strip_dots_kernel<7, V, U, MINB>
              <<<row_grid(n_rows, log_rows, heads * ns_o), kThreads, 0,
                 st>>>(indptr, col, qv, kv, part_lg, n_rows, heads, ov,
                       ns_o, n_edges, log_s, log_rows);
        dot_strip_stats_kernel<7>
            <<<row_grid(n_rows, 0, heads), kThreads, 0, st>>>(
                indptr, part_lg, raw == nullptr ? ns_o : 0, part_vd, ns_d,
                const_cast<float*>(raw), mx, den, s_n, w, nullptr, nullptr,
                n_rows, heads, n_edges, scale, slope);
        dot_strip_spmm_kernel<7, V, U, MINB>
            <<<row_grid(n_rows, log_rows, heads * ns_o), kThreads, 0, st>>>(
                indptr, col, w, kv, dqv, n_rows, heads, ov, ns_o, n_edges,
                log_s, log_rows);
      });
}

// K8 in rows (see dot_bwd_rev_kernel), at the instances with_row_instances
// holds (bfloat16: only the shipped ones, in either build).
template <typename V>
int launch_dot_bwd_rev(const int* indptr, const int* col, const void* q,
                       const void* k, const void* v, const float* mx,
                       const float* den, const float* s_n, const void* dy,
                       void* dk, void* dv_out, int n_rows, int heads, int ov,
                       int dv, int log_rows, int unroll, int reg_cap,
                       float scale, float slope, cudaStream_t st) {
  const int wide = ov > dv ? ov : dv;
  const int lg = log_group(wide);
  if (!dot_layout_ok(lg, log_rows, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = row_grid(n_rows, log_rows, heads);
  return with_row_instances<K8RegisterPick<V>, false, kLow<V>, kLow<V>>(
      wide, unroll, reg_cap, [&](auto nc, auto un, auto minb) {
        dot_bwd_rev_kernel<V, decltype(nc)::value, decltype(un)::value,
                           decltype(minb)::value><<<grid, kThreads, 0, st>>>(
            indptr, col, static_cast<const V*>(q), static_cast<const V*>(k),
            static_cast<const V*>(v), mx, den, s_n,
            static_cast<const V*>(dy), static_cast<V*>(dk),
            static_cast<V*>(dv_out), n_rows, heads, ov, dv, lg, log_rows,
            scale, slope);
      });
}

// K8, staged (see dot_bwd_rev_staged_kernel): bf16x8 rows in NC register
// chunks (with_chunks), the receivers' scalars packed in stats, at the
// instances with_staged_instances holds.
int launch_dot_bwd_rev_staged(const int* indptr, const int* col,
                              const void* q, const void* k, const void* v,
                              const float* stats, const void* dy, void* dk,
                              void* dv_out, int n_rows, int heads, int ov,
                              int dv, int log_rows, int unroll, int stages,
                              int reg_cap, float scale, float slope,
                              cudaStream_t st) {
  using V = bf16x8;
  const int wide = ov > dv ? ov : dv;
  const int lg = log_group(wide);
  if (!dot_layout_ok(lg, log_rows, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = row_grid(n_rows, log_rows, heads);
  int rc = 0;
  const int chunks = with_chunks(wide, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    rc = with_staged_instances<K8StagedPick, NC>(
        unroll, stages, reg_cap, [&](auto un, auto ns, auto minb) {
          constexpr int U = decltype(un)::value, NS = decltype(ns)::value;
          launch_staged(
              dot_bwd_rev_staged_kernel<V, NC, U, NS, decltype(minb)::value>,
              grid, sizeof(RevSlot<V, NC>) * U * NS * kWarpsPerBlock, st,
              indptr, col, static_cast<const V*>(q), static_cast<const V*>(k),
              static_cast<const V*>(v),
              reinterpret_cast<const float4*>(stats),
              static_cast<const V*>(dy), static_cast<V*>(dk),
              static_cast<V*>(dv_out), n_rows, heads, ov, dv, lg, log_rows,
              scale, slope);
        });
  });
  return rc != 0 ? rc : chunks;
}

// K11 in rows (see gatv2_bwd_rev_kernel), at the instances
// with_row_instances holds (bfloat16: the shipped ones and, in the sweep
// build, every pair of one register chunk).
template <typename V>
int launch_gatv2_bwd_rev(const int* indptr, const int* col, const void* q,
                         const void* k, const float* a, const float* mx,
                         const float* den, const float* s_n,
                         const float* stats, const void* dy, void* dk,
                         int n_rows, int heads, int dv,
                         int log_rows, int unroll, int reg_cap, float slope,
                         cudaStream_t st) {
  const int lg = log_group(dv);
  if (!dot_layout_ok(lg, log_rows, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = row_grid(n_rows, log_rows, heads);
  return with_row_instances<K11RegisterPick<V>, false, kLow<V>, kLow<V>>(
      dv, unroll, reg_cap, [&](auto nc, auto un, auto minb) {
        gatv2_bwd_rev_kernel<V, decltype(nc)::value, decltype(un)::value,
                             decltype(minb)::value>
            <<<grid, kThreads, 0, st>>>(
                indptr, col, static_cast<const V*>(q),
                static_cast<const V*>(k), a, mx, den, s_n,
                reinterpret_cast<const float4*>(stats),
                static_cast<const V*>(dy), static_cast<V*>(dk), n_rows,
                heads, dv, lg, log_rows, slope);
      });
}

// K11, staged (see gatv2_bwd_rev_staged_kernel): bf16x8 rows in NC
// register chunks (with_chunks), the receivers' scalars packed in stats,
// at the instances with_staged_instances holds.
int launch_gatv2_bwd_rev_staged(const int* indptr, const int* col,
                                const void* q, const void* k, const float* a,
                                const float* stats, const void* dy, void* dk,
                                int n_rows, int heads, int dv, int log_rows,
                                int unroll, int stages, int reg_cap,
                                bool record, float slope, cudaStream_t st) {
  using V = bf16x8;
  const int lg = log_group(dv);
  if (!dot_layout_ok(lg, log_rows, heads) || (record && dv != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = row_grid(n_rows, log_rows, heads);
  int rc = 0;
  const int chunks = with_chunks(dv, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    rc = with_staged_instances<K11StagedPick, NC>(
        unroll, stages, reg_cap, [&](auto un, auto ns, auto minb) {
          constexpr int U = decltype(un)::value, NS = decltype(ns)::value,
                        MINB = decltype(minb)::value;
          auto go = [&](auto kernel) {
            launch_staged(kernel, grid,
                          sizeof(RevSlot<V, NC>) * U * NS * kWarpsPerBlock,
                          st, indptr, col, static_cast<const V*>(q),
                          static_cast<const V*>(k), a,
                          reinterpret_cast<const float4*>(stats),
                          static_cast<const V*>(dy), static_cast<V*>(dk),
                          n_rows, heads, dv, lg, log_rows, slope);
          };
          if (!record) {
            go(gatv2_bwd_rev_staged_kernel<V, NC, U, NS, MINB>);
          } else if constexpr (NC == 1) {
            go(gatv2_bwd_rev_staged_kernel<V, 1, U, NS, MINB, true>);
          }
        });
  });
  return rc != 0 ? rc : chunks;
}

// K10 in rows (see gatv2_bwd_dq_kernel), at the instances
// with_row_instances holds (bfloat16: only the shipped ones, in either
// build); the block's warps share O floats each of dynamic shared memory
// (above 48 KB, at bfloat16 rows of more than 1,536 values a head, asked
// for with cudaFuncSetAttribute).
template <typename V>
int launch_gatv2_bwd_dq(const int* indptr, const int* col, const void* q,
                        const void* k, const float* a, const float* mx,
                        const float* den, const float* s_n, const void* dy,
                        void* dq, float* da_part, int n_rows, int heads,
                        int dv, int log_rows, int unroll, int reg_cap,
                        float slope, cudaStream_t st) {
  const int lg = log_group(dv);
  if (!dot_layout_ok(lg, log_rows, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = row_grid(n_rows, log_rows, heads);
  const size_t smem = sizeof(Acc<V>) * kWarpsPerBlock * dv;
  return with_row_instances<K10Pick, false, kLow<V>>(
      dv, unroll, reg_cap, [&](auto nc, auto un, auto minb) {
        auto kernel =
            gatv2_bwd_dq_kernel<V, decltype(nc)::value, decltype(un)::value,
                                decltype(minb)::value>;
        if (smem > 48 * 1024 &&
            cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem)) != cudaSuccess)
          return;   // the error stays for with_row_instances to return
        kernel<<<grid, kThreads, smem, st>>>(
            indptr, col, static_cast<const V*>(q), static_cast<const V*>(k),
            a, mx, den, s_n, static_cast<const V*>(dy), static_cast<V*>(dq),
            da_part, n_rows, heads, dv, lg, log_rows, slope);
      });
}

// K5 in rows (see gat_bwd_rev_kernel), at the instances with_row_instances
// holds: rows up to 256 vectors in registers, wider ones in passes of 256.
template <typename V>
int launch_gat_bwd_rev(const int* indptr, const int* col,
                       const Scalar<V>* pi, const Scalar<V>* pj,
                       const void* v, const float* mx, const float* den,
                       const float* s_n, const float* stats, const void* dy,
                       Scalar<V>* dpj, void* dv_out, int n_rows, int heads,
                       int dv, int log_rows, int unroll, int reg_cap,
                       float slope, cudaStream_t st) {
  const int wide = dv < kMaxWide<V> ? dv : kMaxWide<V>;
  const int lg = log_group(wide);
  if (!dot_layout_ok(lg, log_rows, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = row_grid(n_rows, log_rows, heads);
  return with_row_instances<K5Pick, kLow<V>>(
      wide, unroll, reg_cap, [&](auto nc, auto un, auto minb) {
        gat_bwd_rev_kernel<V, decltype(nc)::value, decltype(un)::value,
                           decltype(minb)::value><<<grid, kThreads, 0, st>>>(
            indptr, col, pi, pj, static_cast<const V*>(v), mx, den, s_n,
            reinterpret_cast<const float4*>(stats),
            static_cast<const V*>(dy), dpj, static_cast<V*>(dv_out), n_rows,
            heads, dv, lg, log_rows, slope);
      });
}

// K9 in rows (see gatv2_softmax_rows_kernel), at the instances
// with_row_instances holds (bfloat16: only the shipped ones, in either
// build).
template <typename V>
int launch_gatv2_softmax(const int* indptr, const int* col, const void* q,
                         const void* k, const float* a, void* num, float* m,
                         float* s, int n_rows, int heads, int dv,
                         int log_rows, int unroll, int reg_cap, float slope,
                         cudaStream_t st) {
  const int lg = log_group(dv);
  if (!dot_layout_ok(lg, log_rows, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = row_grid(n_rows, log_rows, heads);
  return with_row_instances<K9Pick, false, kLow<V>>(
      dv, unroll, reg_cap, [&](auto nc, auto un, auto minb) {
        gatv2_softmax_rows_kernel<V, decltype(nc)::value, decltype(un)::value,
                                  decltype(minb)::value>
            <<<grid, kThreads, 0, st>>>(
                indptr, col, static_cast<const V*>(q),
                static_cast<const V*>(k), a, static_cast<V*>(num), m, s,
                n_rows, heads, dv, lg, log_rows, slope);
      });
}

// K3 in rows (see gat_softmax_rows_kernel), at the instances
// with_row_instances holds: rows up to 256 vectors in registers, wider ones
// in passes of 256.
template <typename V>
int launch_gat_softmax(const int* indptr, const int* col,
                       const Scalar<V>* pi, const Scalar<V>* pj,
                       const void* v, void* num, float* m, float* s,
                       int n_rows, int heads, int dv, int log_rows,
                       int unroll, int reg_cap, int ahead, float slope,
                       cudaStream_t st) {
  const int wide = dv < kMaxWide<V> ? dv : kMaxWide<V>;
  const int lg = log_group(wide);
  if (!dot_layout_ok(lg, log_rows, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = row_grid(n_rows, log_rows, heads);
  return with_row_instances<K3Pick, kLow<V>>(
      wide, unroll, reg_cap, [&](auto nc, auto un, auto minb) {
        gat_softmax_rows_kernel<V, decltype(nc)::value, decltype(un)::value,
                                decltype(minb)::value>
            <<<grid, kThreads, 0, st>>>(
                indptr, col, pi, pj, static_cast<const V*>(v),
                static_cast<V*>(num), m, s, n_rows, heads, dv, lg, log_rows,
                ahead, slope);
      });
}

// K12 in rows (see edge_softmax_rows_kernel), at the instances
// with_row_instances holds: rows up to 256 vectors in registers (32 for
// bfloat16), wider ones in passes of that many. interleave is 0 or 1.
template <typename V>
int launch_edge_softmax(const int* indptr, const int* col,
                        const Scalar<V>* lg, const Scalar<V>* mask,
                        const void* v, void* num, float* m, float* s,
                        int n_rows, int heads, int dv, int log_rows,
                        int unroll, int reg_cap, int interleave,
                        cudaStream_t st) {
  const int wide = dv < kMaxWide<V> ? dv : kMaxWide<V>;
  const int lg_ = log_group(wide);
  if (!dot_layout_ok(lg_, log_rows, interleave ? 1 : heads) ||
      interleave & ~1)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid = row_grid(n_rows, log_rows, heads);
  if (interleave) {   // heads side by side in the grid's first dimension
    if ((long long)grid.x * heads > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    grid = dim3(grid.x * heads, 1);
  }
  return with_row_instances<K12Pick, kLow<V>>(
      wide, unroll, reg_cap, [&](auto nc, auto un, auto minb) {
        edge_softmax_rows_kernel<V, decltype(nc)::value, decltype(un)::value,
                                 decltype(minb)::value>
            <<<grid, kThreads, 0, st>>>(
                indptr, col, lg, mask, static_cast<const V*>(v),
                static_cast<V*>(num), m, s, n_rows, heads, dv, lg_,
                log_rows, interleave);
      });
}

// K4 in rows (see gat_bwd_dpi_rows_kernel), at the instances
// with_row_instances holds: rows up to 256 vectors in registers, wider ones
// in passes of 256.
template <typename V>
int launch_gat_bwd_dpi(const int* indptr, const int* col,
                       const Scalar<V>* pi, const Scalar<V>* pj,
                       const void* v, const float* mx, const float* den,
                       const float* s_n, const void* dy, Scalar<V>* dpi,
                       int n_rows, int heads, int dv, int log_rows,
                       int unroll, int reg_cap, int ahead, float slope,
                       cudaStream_t st) {
  const int wide = dv < kMaxWide<V> ? dv : kMaxWide<V>;
  const int lg = log_group(wide);
  if (!dot_layout_ok(lg, log_rows, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = row_grid(n_rows, log_rows, heads);
  return with_row_instances<K4Pick, kLow<V>>(
      wide, unroll, reg_cap, [&](auto nc, auto un, auto minb) {
        gat_bwd_dpi_rows_kernel<V, decltype(nc)::value, decltype(un)::value,
                                decltype(minb)::value>
            <<<grid, kThreads, 0, st>>>(
                indptr, col, pi, pj, static_cast<const V*>(v), mx, den, s_n,
                static_cast<const V*>(dy), dpi, n_rows, heads, dv, lg,
                log_rows, ahead, slope);
      });
}

bool dot_float4(int o, int d, std::initializer_list<const void*> rows) {
  if (o % 4 != 0 || d % 4 != 0) return false;
  for (const void* p : rows)
    if (!aligned16(p)) return false;
  return true;
}

// The widest vector bfloat16 dot rows take: one for q and k (o values) and
// v, dy (d values) alike, so the narrower of bf16_vec_bytes' two picks.
int dot_bf16_vec(int o, int d, std::initializer_list<const void*> rows) {
  const int a = bf16_vec_bytes(o, rows), b = bf16_vec_bytes(d, rows);
  return a < b ? a : b;
}

}  // namespace

// Every function returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue, with nothing launched, for a layout
// or width the library does not take. The caller allocates every output
// and makes sure n_rows > 0 and 0 < heads < 65536 (the grid's second
// dimension).
extern "C" {

// K12. num [n_rows, H, d], m and s [n_rows, H]. col == NULL: values are
// per edge [E, H, d]; else per node, indexed by col. mask may be NULL.
// lg and mask [E, H]. Any d: rows of more than 256 vectors (float4 when
// d % 4 == 0 and v and num are 16-byte aligned) take passes of 256.
// log_rows, unroll and reg_cap as K11 (see with_row_instances and K12Pick
// for the instances built); interleave (0 or 1) as
// edge_softmax_rows_kernel reads it.
int edge_softmax_f32(const int* indptr, const int* col, const float* lg,
                     const float* mask, const float* v, float* num, float* m,
                     float* s, int n_rows, int heads, int d, int log_rows,
                     int unroll, int reg_cap, int interleave, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(v) && aligned16(num))
    return launch_edge_softmax<float4>(indptr, col, lg, mask, v, num, m, s,
                                       n_rows, heads, d / 4, log_rows, unroll,
                                       reg_cap, interleave, st);
  return launch_edge_softmax<float>(indptr, col, lg, mask, v, num, m, s,
                                    n_rows, heads, d, log_rows, unroll,
                                    reg_cap, interleave, st);
}

// K12 on bfloat16 logits, mask and values, with the float32 softmax state
// (m, s), as edge_softmax_f32: the sums in float32, num rounded once. A row
// loads in the widest vector it takes (bf16_vec_bytes of the value and
// output rows: 8 values, 4, or one); the instances hold one register chunk
// of 32 vectors (see with_row_instances), wider rows take passes of 32.
int edge_softmax_bf16(const int* indptr, const int* col, const bf16x1* lg,
                      const bf16x1* mask, const bf16x1* v, bf16x1* num,
                      float* m, float* s, int n_rows, int heads, int d,
                      int log_rows, int unroll, int reg_cap, int interleave,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bf16_vec_bytes(d, {v, num})) {
    case 16:
      return launch_edge_softmax<bf16x8>(indptr, col, lg, mask, v, num, m, s,
                                         n_rows, heads, d / 8, log_rows,
                                         unroll, reg_cap, interleave, st);
    case 8:
      return launch_edge_softmax<bf16x4>(indptr, col, lg, mask, v, num, m, s,
                                         n_rows, heads, d / 4, log_rows,
                                         unroll, reg_cap, interleave, st);
    default:
      return launch_edge_softmax<bf16x1>(indptr, col, lg, mask, v, num, m, s,
                                         n_rows, heads, d, log_rows, unroll,
                                         reg_cap, interleave, st);
  }
}

// K3. pi [n_rows, H], pj [n_src, H], v [n_src, H, d]; outputs as K12.
// Any d: rows of more than 256 vectors (float4 when d % 4 == 0 and v and
// num are 16-byte aligned) take passes of 256. log_rows, unroll and reg_cap
// as K11 (see with_row_instances and K3Pick for the instances built); ahead
// (0 or 1): the lane holding an edge's index loads its pj one window ahead.
int gat_softmax_f32(const int* indptr, const int* col, const float* pi,
                    const float* pj, const float* v, float* num, float* m,
                    float* s, int n_rows, int heads, int d, int log_rows,
                    int unroll, int reg_cap, int ahead, float slope,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(v) && aligned16(num))
    return launch_gat_softmax<float4>(indptr, col, pi, pj, v, num, m, s,
                                      n_rows, heads, d / 4, log_rows, unroll,
                                      reg_cap, ahead, slope, st);
  return launch_gat_softmax<float>(indptr, col, pi, pj, v, num, m, s, n_rows,
                                   heads, d, log_rows, unroll, reg_cap,
                                   ahead, slope, st);
}

// K4. Over the receiver CSR of n_rows receivers: dpi [n_rows, H]; pj and
// v are the senders'. Any d, as K3. log_rows, unroll, reg_cap and ahead as
// K3 (see with_row_instances and K4Pick for the instances built).
int gat_bwd_dpi_f32(const int* indptr, const int* col, const float* pi,
                    const float* pj, const float* v, const float* mx,
                    const float* den, const float* s_n, const float* dy,
                    float* dpi, int n_rows, int heads, int d, int log_rows,
                    int unroll, int reg_cap, int ahead, float slope,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(v) && aligned16(dy))
    return launch_gat_bwd_dpi<float4>(indptr, col, pi, pj, v, mx, den, s_n,
                                      dy, dpi, n_rows, heads, d / 4,
                                      log_rows, unroll, reg_cap, ahead, slope,
                                      st);
  return launch_gat_bwd_dpi<float>(indptr, col, pi, pj, v, mx, den, s_n, dy,
                                   dpi, n_rows, heads, d, log_rows, unroll,
                                   reg_cap, ahead, slope, st);
}

// K5. Over the sender CSR of n_rows senders: dpj [n_rows, H] and
// dv [n_rows, H, d]; pi, mx, den, s_n and dy are the receivers'. stats
// (NULL: none) packs pi, mx, den and s_n as [rows, H, 4], 16-byte aligned,
// read in their place. Any d: rows of more than 256 vectors (float4 when d
// % 4 == 0 and v, dy and dv are 16-byte aligned) take passes of 256.
// log_rows, unroll and reg_cap as K11 (see with_row_instances and K5Pick
// for the instances built).
int gat_bwd_rev_f32(const int* indptr, const int* col, const float* pi,
                    const float* pj, const float* v, const float* mx,
                    const float* den, const float* s_n, const float* stats,
                    const float* dy, float* dpj, float* dv, int n_rows,
                    int heads, int d, int log_rows, int unroll, int reg_cap,
                    float slope, void* stream) {
  if (!aligned16(stats)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(v) && aligned16(dy) && aligned16(dv))
    return launch_gat_bwd_rev<float4>(indptr, col, pi, pj, v, mx, den, s_n,
                                      stats, dy, dpj, dv, n_rows, heads,
                                      d / 4, log_rows, unroll, reg_cap, slope,
                                      st);
  return launch_gat_bwd_rev<float>(indptr, col, pi, pj, v, mx, den, s_n,
                                   stats, dy, dpj, dv, n_rows, heads, d,
                                   log_rows, unroll, reg_cap, slope, st);
}

// K3, K4 and K5 on bfloat16 rows and per-node scalars (pi, pj; dpi, dpj),
// with the float32 softmax state (m, s; mx, den, s_n; stats), as
// gat_softmax_f32, gat_bwd_dpi_f32 and gat_bwd_rev_f32: each sum in
// float32, each bfloat16 output rounded once. A row loads in the widest
// vector it takes (bf16_vec_bytes of the value and output rows: 8 values,
// 4, or one); the instances hold one register chunk of 32 vectors (see
// with_row_instances), wider rows take passes of 32.
int gat_softmax_bf16(const int* indptr, const int* col, const bf16x1* pi,
                     const bf16x1* pj, const bf16x1* v, bf16x1* num, float* m,
                     float* s, int n_rows, int heads, int d, int log_rows,
                     int unroll, int reg_cap, int ahead, float slope,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bf16_vec_bytes(d, {v, num})) {
    case 16:
      return launch_gat_softmax<bf16x8>(indptr, col, pi, pj, v, num, m, s,
                                        n_rows, heads, d / 8, log_rows,
                                        unroll, reg_cap, ahead, slope, st);
    case 8:
      return launch_gat_softmax<bf16x4>(indptr, col, pi, pj, v, num, m, s,
                                        n_rows, heads, d / 4, log_rows,
                                        unroll, reg_cap, ahead, slope, st);
    default:
      return launch_gat_softmax<bf16x1>(indptr, col, pi, pj, v, num, m, s,
                                        n_rows, heads, d, log_rows, unroll,
                                        reg_cap, ahead, slope, st);
  }
}

int gat_bwd_dpi_bf16(const int* indptr, const int* col, const bf16x1* pi,
                     const bf16x1* pj, const bf16x1* v, const float* mx,
                     const float* den, const float* s_n, const bf16x1* dy,
                     bf16x1* dpi, int n_rows, int heads, int d, int log_rows,
                     int unroll, int reg_cap, int ahead, float slope,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bf16_vec_bytes(d, {v, dy})) {
    case 16:
      return launch_gat_bwd_dpi<bf16x8>(indptr, col, pi, pj, v, mx, den, s_n,
                                        dy, dpi, n_rows, heads, d / 8,
                                        log_rows, unroll, reg_cap, ahead,
                                        slope, st);
    case 8:
      return launch_gat_bwd_dpi<bf16x4>(indptr, col, pi, pj, v, mx, den, s_n,
                                        dy, dpi, n_rows, heads, d / 4,
                                        log_rows, unroll, reg_cap, ahead,
                                        slope, st);
    default:
      return launch_gat_bwd_dpi<bf16x1>(indptr, col, pi, pj, v, mx, den, s_n,
                                        dy, dpi, n_rows, heads, d, log_rows,
                                        unroll, reg_cap, ahead, slope, st);
  }
}

int gat_bwd_rev_bf16(const int* indptr, const int* col, const bf16x1* pi,
                     const bf16x1* pj, const bf16x1* v, const float* mx,
                     const float* den, const float* s_n, const float* stats,
                     const bf16x1* dy, bf16x1* dpj, bf16x1* dv, int n_rows,
                     int heads, int d, int log_rows, int unroll, int reg_cap,
                     float slope, void* stream) {
  if (!aligned16(stats)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bf16_vec_bytes(d, {v, dy, dv})) {
    case 16:
      return launch_gat_bwd_rev<bf16x8>(indptr, col, pi, pj, v, mx, den, s_n,
                                        stats, dy, dpj, dv, n_rows, heads,
                                        d / 8, log_rows, unroll, reg_cap,
                                        slope, st);
    case 8:
      return launch_gat_bwd_rev<bf16x4>(indptr, col, pi, pj, v, mx, den, s_n,
                                        stats, dy, dpj, dv, n_rows, heads,
                                        d / 4, log_rows, unroll, reg_cap,
                                        slope, st);
    default:
      return launch_gat_bwd_rev<bf16x1>(indptr, col, pi, pj, v, mx, den, s_n,
                                        stats, dy, dpj, dv, n_rows, heads, d,
                                        log_rows, unroll, reg_cap, slope, st);
  }
}

// K9. Over the receiver CSR of n_rows receivers: q [n_rows, H, d],
// k [n_src, H, d], a [d, H]; num [n_rows, H, d], m and s [n_rows, H].
// float4 rows take d <= 1024, scalar rows d <= 256; wider returns
// cudaErrorInvalidValue. log_rows, unroll and reg_cap as K11 (see
// with_row_instances and K9Pick for the instances built).
int gatv2_softmax_f32(const int* indptr, const int* col, const float* q,
                      const float* k, const float* a, float* num, float* m,
                      float* s, int n_rows, int heads, int d, int log_rows,
                      int unroll, int reg_cap, float slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(num))
    return launch_gatv2_softmax<float4>(indptr, col, q, k, a, num, m, s,
                                        n_rows, heads, d / 4, log_rows,
                                        unroll, reg_cap, slope, st);
  return launch_gatv2_softmax<float>(indptr, col, q, k, a, num, m, s, n_rows,
                                     heads, d, log_rows, unroll, reg_cap,
                                     slope, st);
}

// K10, first launch. Over the receiver CSR: dq [n_rows, H, d] and
// da_part [H, d, blocks], each block's share of da (blocks: the grid's
// first dimension, ceil(ceil(n_rows / 2^log_rows) / 8)). Widths as K9;
// log_rows, unroll and reg_cap as K11 (see with_row_instances and K10Pick
// for the instances built).
int gatv2_bwd_dq_f32(const int* indptr, const int* col, const float* q,
                     const float* k, const float* a, const float* mx,
                     const float* den, const float* s_n, const float* dy,
                     float* dq, float* da_part, int n_rows, int heads, int d,
                     int log_rows, int unroll, int reg_cap, float slope,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(dy) &&
      aligned16(dq))
    return launch_gatv2_bwd_dq<float4>(indptr, col, q, k, a, mx, den, s_n, dy,
                                       dq, da_part, n_rows, heads, d / 4,
                                       log_rows, unroll, reg_cap, slope, st);
  return launch_gatv2_bwd_dq<float>(indptr, col, q, k, a, mx, den, s_n, dy,
                                    dq, da_part, n_rows, heads, d, log_rows,
                                    unroll, reg_cap, slope, st);
}

// K10, second launch: da [d, H] from da_part [H, d, blocks].
int gatv2_da_reduce_f32(const float* da_part, float* da, int blocks,
                        int heads, int d, void* stream) {
  if (d <= 0 || heads <= 0 || heads >= 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gatv2_da_reduce_kernel<<<dim3(d, heads), kThreads, 0, st>>>(
      da_part, da, blocks, heads, d);
  return static_cast<int>(cudaGetLastError());
}

// K11. Over the sender CSR of n_rows senders: dk [n_rows, H, d]; q, mx,
// den, s_n and dy are the receivers'. stats (NULL: none) packs mx, den and
// s_n as [rows, H, 4] (the fourth unused), 16-byte aligned, read in their
// place. Widths as K9. log_rows: log2 of the sender rows per warp; unroll:
// the edges an edge group loads before it reduces them; reg_cap: 0 (none)
// or 64 registers per thread (see with_row_instances and K11Pick for the
// instances built).
int gatv2_bwd_rev_f32(const int* indptr, const int* col, const float* q,
                      const float* k, const float* a, const float* mx,
                      const float* den, const float* s_n, const float* stats,
                      const float* dy, float* dk, int n_rows, int heads,
                      int d, int log_rows, int unroll, int reg_cap,
                      float slope, void* stream) {
  if (!aligned16(stats)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(dy) &&
      aligned16(dk))
    return launch_gatv2_bwd_rev<float4>(indptr, col, q, k, a, mx, den, s_n,
                                        stats, dy, dk, n_rows, heads, d / 4,
                                        log_rows, unroll, reg_cap, slope, st);
  return launch_gatv2_bwd_rev<float>(indptr, col, q, k, a, mx, den, s_n,
                                     stats, dy, dk, n_rows, heads, d,
                                     log_rows, unroll, reg_cap, slope, st);
}

// K9, K10 (the dq walk; its da shares and gatv2_da_reduce_f32 stay
// float32) and K11 on bfloat16 rows (q, k, dy; num, dq, dk), with a in
// float32 and the float32 softmax state (m, s; mx, den, s_n; stats), as
// gatv2_softmax_f32, gatv2_bwd_dq_f32 and gatv2_bwd_rev_f32: each sum in
// float32, each bfloat16 output rounded once. A row loads in the widest
// vector it takes (bf16_vec_bytes of the row operands: 8 values, 4, or
// one); the instances hold up to 256 vectors, as the float32 ones (so 2,048
// values a head at 8 a vector, 256 at one). K11's stages: 0, the register
// kernel (gatv2_bwd_rev_kernel); 2 or more, the staged one
// (gatv2_bwd_rev_staged_kernel), on bf16x8 rows only, reading the
// receivers' mx, den and s_n packed in stats (see with_staged_instances
// for the instances built). K11's packed: 0, stats NULL; 1, stats [rows,
// H, 4] (mx, den, s_n, unused); 2 (staged, d == 8 only), stats [rows, H,
// 8], 32-byte aligned, each receiver's q row (16 bytes) and then its mx,
// den, s_n and an unused float (kRecord). Any other returns
// cudaErrorInvalidValue.
int gatv2_softmax_bf16(const int* indptr, const int* col, const bf16x1* q,
                       const bf16x1* k, const float* a, bf16x1* num, float* m,
                       float* s, int n_rows, int heads, int d, int log_rows,
                       int unroll, int reg_cap, float slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bf16_vec_bytes(d, {q, k, num})) {
    case 16:
      return launch_gatv2_softmax<bf16x8>(indptr, col, q, k, a, num, m, s,
                                          n_rows, heads, d / 8, log_rows,
                                          unroll, reg_cap, slope, st);
    case 8:
      return launch_gatv2_softmax<bf16x4>(indptr, col, q, k, a, num, m, s,
                                          n_rows, heads, d / 4, log_rows,
                                          unroll, reg_cap, slope, st);
    default:
      return launch_gatv2_softmax<bf16x1>(indptr, col, q, k, a, num, m, s,
                                          n_rows, heads, d, log_rows, unroll,
                                          reg_cap, slope, st);
  }
}

int gatv2_bwd_dq_bf16(const int* indptr, const int* col, const bf16x1* q,
                      const bf16x1* k, const float* a, const float* mx,
                      const float* den, const float* s_n, const bf16x1* dy,
                      bf16x1* dq, float* da_part, int n_rows, int heads,
                      int d, int log_rows, int unroll, int reg_cap,
                      float slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bf16_vec_bytes(d, {q, k, dy, dq})) {
    case 16:
      return launch_gatv2_bwd_dq<bf16x8>(indptr, col, q, k, a, mx, den, s_n,
                                         dy, dq, da_part, n_rows, heads,
                                         d / 8, log_rows, unroll, reg_cap,
                                         slope, st);
    case 8:
      return launch_gatv2_bwd_dq<bf16x4>(indptr, col, q, k, a, mx, den, s_n,
                                         dy, dq, da_part, n_rows, heads,
                                         d / 4, log_rows, unroll, reg_cap,
                                         slope, st);
    default:
      return launch_gatv2_bwd_dq<bf16x1>(indptr, col, q, k, a, mx, den, s_n,
                                         dy, dq, da_part, n_rows, heads, d,
                                         log_rows, unroll, reg_cap, slope,
                                         st);
  }
}

int gatv2_bwd_rev_bf16(const int* indptr, const int* col, const bf16x1* q,
                       const bf16x1* k, const float* a, const float* mx,
                       const float* den, const float* s_n,
                       const float* stats, const bf16x1* dy, bf16x1* dk,
                       int n_rows, int heads, int d, int log_rows,
                       int unroll, int reg_cap, int packed, int stages,
                       float slope, void* stream) {
  if (!aligned16(stats) || packed < 0 || packed > 2 ||
      (packed == 0) != (stats == nullptr) ||
      (packed == 2 && (stages == 0 ||
                       (reinterpret_cast<uintptr_t>(stats) & 31u) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = bf16_vec_bytes(d, {q, k, dy, dk});
  if (stages) {
    if (vec != 16 || stats == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_gatv2_bwd_rev_staged(indptr, col, q, k, a, stats, dy, dk,
                                       n_rows, heads, d / 8, log_rows,
                                       unroll, stages, reg_cap, packed == 2,
                                       slope, st);
  }
  switch (vec) {
    case 16:
      return launch_gatv2_bwd_rev<bf16x8>(indptr, col, q, k, a, mx, den, s_n,
                                          stats, dy, dk, n_rows, heads, d / 8,
                                          log_rows, unroll, reg_cap, slope,
                                          st);
    case 8:
      return launch_gatv2_bwd_rev<bf16x4>(indptr, col, q, k, a, mx, den, s_n,
                                          stats, dy, dk, n_rows, heads, d / 4,
                                          log_rows, unroll, reg_cap, slope,
                                          st);
    default:
      return launch_gatv2_bwd_rev<bf16x1>(indptr, col, q, k, a, mx, den, s_n,
                                          stats, dy, dk, n_rows, heads, d,
                                          log_rows, unroll, reg_cap, slope,
                                          st);
  }
}

// K6. Over the receiver CSR of n_rows receivers and n_edges edges:
// q [n_rows, H, o], k [n_src, H, o], v [n_src, H, d]; num [n_rows, H, d],
// m and s [n_rows, H], raw [n_edges, H] each edge's raw logit scale * <q[r],
// k[s]> (NULL: not written, in rows only). slope 1 is the plain dot. float4
// vectors when o and d are multiples of 4 and every row pointer is 16-byte
// aligned; the wider of o and d may be 1024 floats with float4 vectors, 256
// without; wider returns cudaErrorInvalidValue. The layout: strips 0 (rows)
// or 1 (strips; raw required, and scratch of H * (ceil(o / S) + 1) *
// n_edges floats, S = 8 float4 vectors or 32 floats: one 128-byte line);
// log_rows: log2 of the rows per warp; unroll: the edges (rows) or gathers
// (strips) a group issues before it reduces them; reg_cap: 0 (none) or 64
// registers a thread (see with_row_instances and with_strip_instances for
// the instances built).
int dot_softmax_f32(const int* indptr, const int* col, const float* q,
                    const float* k, const float* v, float* num, float* m,
                    float* s, float* raw, float* scratch, int n_rows,
                    int heads, int o, int d, int n_edges, int strips,
                    int log_rows, int unroll, int reg_cap, float scale,
                    float slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dot_float4(o, d, {q, k, v, num}))
    return launch_dot_softmax<float4>(
        indptr, col, q, k, v, num, m, s, raw, scratch, n_rows, heads, o / 4,
        d / 4, n_edges, strips, log_rows, unroll, reg_cap, scale, slope, st);
  return launch_dot_softmax<float>(indptr, col, q, k, v, num, m, s, raw,
                                   scratch, n_rows, heads, o, d, n_edges,
                                   strips, log_rows, unroll, reg_cap, scale,
                                   slope, st);
}

// K7. Over the receiver CSR: dq [n_rows, H, o]. mx, den, s_n and dy
// [n_rows, H(, d)] are the receivers'; raw [n_edges, H] K6's raw logits
// (NULL: recomputed from q and k). Widths and layout as K6; strips take
// scratch of H * (1 + ceil(d / S)) * n_edges floats, plus H * ceil(o / S) *
// n_edges without raw.
int dot_bwd_dq_f32(const int* indptr, const int* col, const float* q,
                   const float* k, const float* v, const float* mx,
                   const float* den, const float* s_n, const float* dy,
                   const float* raw, float* dq, float* scratch, int n_rows,
                   int heads, int o, int d, int n_edges, int strips,
                   int log_rows, int unroll, int reg_cap, float scale,
                   float slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dot_float4(o, d, {q, k, v, dy, dq}))
    return launch_dot_bwd_dq<float4>(
        indptr, col, q, k, v, mx, den, s_n, dy, raw, dq, scratch, n_rows,
        heads, o / 4, d / 4, n_edges, strips, log_rows, unroll, reg_cap,
        scale, slope, st);
  return launch_dot_bwd_dq<float>(indptr, col, q, k, v, mx, den, s_n, dy,
                                  raw, dq, scratch, n_rows, heads, o, d,
                                  n_edges, strips, log_rows, unroll, reg_cap,
                                  scale, slope, st);
}

// K8. Over the sender CSR of n_rows senders: dk [n_rows, H, o] and
// dv [n_rows, H, d]; q, mx, den, s_n and dy are the receivers'. Widths as
// K6. log_rows: log2 of the sender rows per warp; unroll: the edges an edge
// group loads before it reduces them; reg_cap: 0 (none) or 64 registers per
// thread (see with_row_instances for the instances built).
int dot_bwd_rev_f32(const int* indptr, const int* col, const float* q,
                    const float* k, const float* v, const float* mx,
                    const float* den, const float* s_n, const float* dy,
                    float* dk, float* dv, int n_rows, int heads, int o, int d,
                    int log_rows, int unroll, int reg_cap, float scale,
                    float slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dot_float4(o, d, {q, k, v, dy, dk, dv}))
    return launch_dot_bwd_rev<float4>(indptr, col, q, k, v, mx, den, s_n, dy,
                                      dk, dv, n_rows, heads, o / 4, d / 4,
                                      log_rows, unroll, reg_cap, scale,
                                      slope, st);
  return launch_dot_bwd_rev<float>(indptr, col, q, k, v, mx, den, s_n, dy, dk,
                                   dv, n_rows, heads, o, d, log_rows, unroll,
                                   reg_cap, scale, slope, st);
}

// K6, K7 and K8 on bfloat16 rows (q, k, v, dy; num, dq, dk, dv), with the
// float32 softmax state (m, s; mx, den, s_n), raw logits (raw) and strip
// scratch, as dot_softmax_f32, dot_bwd_dq_f32 and dot_bwd_rev_f32: the
// dots, the logits and every sum in float32, each bfloat16 output rounded
// once (a strip writes its own columns). Rows load in the widest vector
// both widths take (dot_bf16_vec: 8 values, 4, or one); the wider of o and
// d may be 256 vectors (2,048 values at 8 a vector, 256 at one). Strips
// are a 128-byte line wide (8 bf16x8 or 16 bf16x4 vectors) or 32 single
// values: scratch as dot_softmax_f32's with S that many vectors. K8's
// stages: 0, the register kernel (dot_bwd_rev_kernel); 2 or more, the
// staged one (dot_bwd_rev_staged_kernel), on bf16x8 rows only, reading the
// receivers' mx, den and s_n packed in stats [rows, H, 4], 16-byte aligned
// (see with_staged_instances for the instances built); any other returns
// cudaErrorInvalidValue.
int dot_softmax_bf16(const int* indptr, const int* col, const bf16x1* q,
                     const bf16x1* k, const bf16x1* v, bf16x1* num, float* m,
                     float* s, float* raw, float* scratch, int n_rows,
                     int heads, int o, int d, int n_edges, int strips,
                     int log_rows, int unroll, int reg_cap, float scale,
                     float slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dot_bf16_vec(o, d, {q, k, v, num})) {
    case 16:
      return launch_dot_softmax<bf16x8>(
          indptr, col, q, k, v, num, m, s, raw, scratch, n_rows, heads,
          o / 8, d / 8, n_edges, strips, log_rows, unroll, reg_cap, scale,
          slope, st);
    case 8:
      return launch_dot_softmax<bf16x4>(
          indptr, col, q, k, v, num, m, s, raw, scratch, n_rows, heads,
          o / 4, d / 4, n_edges, strips, log_rows, unroll, reg_cap, scale,
          slope, st);
    default:
      return launch_dot_softmax<bf16x1>(
          indptr, col, q, k, v, num, m, s, raw, scratch, n_rows, heads, o,
          d, n_edges, strips, log_rows, unroll, reg_cap, scale, slope, st);
  }
}

int dot_bwd_dq_bf16(const int* indptr, const int* col, const bf16x1* q,
                    const bf16x1* k, const bf16x1* v, const float* mx,
                    const float* den, const float* s_n, const bf16x1* dy,
                    const float* raw, bf16x1* dq, float* scratch, int n_rows,
                    int heads, int o, int d, int n_edges, int strips,
                    int log_rows, int unroll, int reg_cap, float scale,
                    float slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dot_bf16_vec(o, d, {q, k, v, dy, dq})) {
    case 16:
      return launch_dot_bwd_dq<bf16x8>(
          indptr, col, q, k, v, mx, den, s_n, dy, raw, dq, scratch, n_rows,
          heads, o / 8, d / 8, n_edges, strips, log_rows, unroll, reg_cap,
          scale, slope, st);
    case 8:
      return launch_dot_bwd_dq<bf16x4>(
          indptr, col, q, k, v, mx, den, s_n, dy, raw, dq, scratch, n_rows,
          heads, o / 4, d / 4, n_edges, strips, log_rows, unroll, reg_cap,
          scale, slope, st);
    default:
      return launch_dot_bwd_dq<bf16x1>(
          indptr, col, q, k, v, mx, den, s_n, dy, raw, dq, scratch, n_rows,
          heads, o, d, n_edges, strips, log_rows, unroll, reg_cap, scale,
          slope, st);
  }
}

int dot_bwd_rev_bf16(const int* indptr, const int* col, const bf16x1* q,
                     const bf16x1* k, const bf16x1* v, const float* mx,
                     const float* den, const float* s_n, const float* stats,
                     const bf16x1* dy, bf16x1* dk, bf16x1* dv, int n_rows,
                     int heads, int o, int d, int log_rows, int unroll,
                     int reg_cap, int stages, float scale, float slope,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = dot_bf16_vec(o, d, {q, k, v, dy, dk, dv});
  if (stages) {
    if (vec != 16 || stats == nullptr || !aligned16(stats))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_dot_bwd_rev_staged(indptr, col, q, k, v, stats, dy, dk, dv,
                                     n_rows, heads, o / 8, d / 8, log_rows,
                                     unroll, stages, reg_cap, scale, slope,
                                     st);
  }
  switch (vec) {
    case 16:
      return launch_dot_bwd_rev<bf16x8>(indptr, col, q, k, v, mx, den, s_n,
                                        dy, dk, dv, n_rows, heads, o / 8,
                                        d / 8, log_rows, unroll, reg_cap,
                                        scale, slope, st);
    case 8:
      return launch_dot_bwd_rev<bf16x4>(indptr, col, q, k, v, mx, den, s_n,
                                        dy, dk, dv, n_rows, heads, o / 4,
                                        d / 4, log_rows, unroll, reg_cap,
                                        scale, slope, st);
    default:
      return launch_dot_bwd_rev<bf16x1>(indptr, col, q, k, v, mx, den, s_n,
                                        dy, dk, dv, n_rows, heads, o, d,
                                        log_rows, unroll, reg_cap, scale,
                                        slope, st);
  }
}

const char* gnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
