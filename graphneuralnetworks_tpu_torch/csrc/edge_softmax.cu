// Edge softmax over a node's in-edges, with aggregation: K3 to K12, float32,
// for sm_90a.
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
// Layout of the work: one warp owns one (row, head) pair, so all heads run
// in one launch and every output entry is written once by one warp, in a
// fixed order, with no atomics. As in spmm.cu, a head's D floats are split
// into vectors (float4 when D % 4 == 0 and the pointers are 16-byte
// aligned), a warp splits into groups of G lanes (G = the vector count,
// rounded up to a power of two, at most 32) that take interleaved edges,
// and rows wider than 32 vectors loop over chunks. K3's and K12's softmax
// takes two passes over a row's edges: the row max of the logits first (scalars
// only), then exp(logit - max), their sum and the weighted sum of value
// rows. So no running rescale is needed, and the value rows are read once
// per chunk.
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

// Vector forms for GATv2, whose logits need whole O-wide rows.
__device__ __forceinline__ float4 lrelu(const float4& r, float slope) {
  return make_float4(lrelu(r.x, slope), lrelu(r.y, slope), lrelu(r.z, slope),
                     lrelu(r.w, slope));
}
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ void vscale(float& a, float s) { a *= s; }
__device__ __forceinline__ void vscale(float4& a, float s) {
  a.x *= s;
  a.y *= s;
  a.z *= s;
  a.w *= s;
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

// Vector f of head h's attention weights, read from a [O, H] (row-major).
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

// Sums over one edge group of g lanes (a power of two); every lane of the
// warp takes part, and every lane of a group ends with the same bits.
__device__ __forceinline__ float group_sum(float x, int g) {
  for (int off = 1; off < g; off <<= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}
__device__ __forceinline__ void group_sum2(float& x, float& y, int g) {
  for (int off = 1; off < g; off <<= 1) {
    x += __shfl_xor_sync(kFull, x, off);
    y += __shfl_xor_sync(kFull, y, off);
  }
}

// Where in the warp a lane works: its edge group and its vector in a chunk.
struct Lanes {
  int lane, g, p, grp, sub;
  __device__ Lanes(int log_g) {
    lane = threadIdx.x & 31;
    g = 1 << log_g;     // lanes per edge group
    p = 32 >> log_g;    // edge groups per warp
    grp = lane >> log_g;
    sub = lane & (g - 1);
  }
};

// The (row, head) pair of this warp, or false past the last one.
__device__ __forceinline__ bool warp_task(int n_rows, int heads, int& row,
                                          int& h) {
  const long long w =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= (long long)n_rows * heads) return false;  // warp-uniform
  row = (int)(w / heads);
  h = (int)(w % heads);
  return true;
}

// Logit of receiver-CSR position e whose sender is c.
struct GivenLogit {    // K12: logits[e, h]
  const float* lg;
  int heads, h;
  __device__ float operator()(int e, int) const {
    return lg[(long long)e * heads + h];
  }
};
struct GatLogit {      // K3: lrelu(pi[r, h] + pj[c, h])
  const float* pj;
  float pir, slope;
  int heads, h;
  __device__ float operator()(int, int c) const {
    return lrelu(pir + pj[(long long)c * heads + h], slope);
  }
};

// One (row, head) of the forward softmax-aggregate over a receiver CSR row
// [beg, end):  m = max_e lg_e,  p_e = exp(lg_e - m),  s = sum_e p_e,
// num = sum_e p_e * mask_e * v[src_e]  with src_e = col[e] (node values) or
// e (edge values, col == NULL). A row with no edges, or whose logits are all
// -inf, gets m = -inf, s = 0 and num = 0.
template <typename V, typename Logit>
__device__ void softmax_aggregate_row(int beg, int end, const int* col,
                                      const float* mask, const V* v,
                                      int heads, int h, int dv, int log_g,
                                      const Logit& logit, V* num_row,
                                      float* m_out, float* s_out) {
  const Lanes L(log_g);
  float mx = -INFINITY;
  for (int e = beg + L.lane; e < end; e += 32)
    mx = fmaxf(mx, logit(e, col ? col[e] : e));
  mx = warp_max(mx);
  const bool dead = mx == -INFINITY;
  float s = 0.f;
  // at least one pass, so that s is summed when D == 0
  for (int c0 = 0; c0 == 0 || c0 < dv; c0 += L.g) {
    const int f = c0 + L.sub;
    const bool active = f < dv;
    V acc = vzero<V>();
    for (int base = beg; base < end; base += 32) {
      const int e = base + L.lane;
      int my_src = 0;
      float my_w = 0.f;
      if (e < end) {
        my_src = col ? col[e] : e;
        const float pe = dead ? 0.f : expf(logit(e, my_src) - mx);
        if (c0 == 0) s += pe;
        my_w = mask ? pe * mask[(long long)e * heads + h] : pe;
      }
      const int cnt = min(32, end - base);
      for (int j0 = 0; j0 < cnt; j0 += L.p) {  // warp-uniform trip count
        const int j = j0 + L.grp;
        const int src = __shfl_sync(kFull, my_src, j);
        const float wj = __shfl_sync(kFull, my_w, j);
        if (active && j < cnt)
          axpy(acc, wj, v[((long long)src * heads + h) * dv + f]);
      }
    }
    for (int off = L.g; off < 32; off <<= 1) add_xor(acc, off);
    if (active && L.grp == 0) num_row[f] = acc;
  }
  s = warp_sum(s);
  if (L.lane == 0) {
    *m_out = mx;
    *s_out = s;
  }
}

// K12, replacing _flash_kernel. Over the receiver CSR.
template <typename V>
__global__ void __launch_bounds__(kThreads)
edge_softmax_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                    const float* __restrict__ lg,
                    const float* __restrict__ mask, const V* __restrict__ v,
                    V* __restrict__ num, float* __restrict__ m,
                    float* __restrict__ s, int n_rows, int heads, int dv,
                    int log_g) {
  int row, h;
  if (!warp_task(n_rows, heads, row, h)) return;
  const long long rh = (long long)row * heads + h;
  softmax_aggregate_row<V>(indptr[row], indptr[row + 1], col, mask, v, heads,
                           h, dv, log_g, GivenLogit{lg, heads, h},
                           num + rh * dv, m + rh, s + rh);
}

// K3, replacing _flash_gat_kernel. Over the receiver CSR; values are node
// rows of the senders.
template <typename V>
__global__ void __launch_bounds__(kThreads)
gat_softmax_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                   const float* __restrict__ pi, const float* __restrict__ pj,
                   const V* __restrict__ v, V* __restrict__ num,
                   float* __restrict__ m, float* __restrict__ s, int n_rows,
                   int heads, int dv, int log_g, float slope) {
  int row, h;
  if (!warp_task(n_rows, heads, row, h)) return;
  const long long rh = (long long)row * heads + h;
  softmax_aggregate_row<V>(indptr[row], indptr[row + 1], col, nullptr, v,
                           heads, h, dv, log_g,
                           GatLogit{pj, pi[rh], slope, heads, h},
                           num + rh * dv, m + rh, s + rh);
}

// K4, replacing _gat_bwd_dpi_kernel. Over the receiver CSR, row r:
//   alpha_e = exp(lrelu(raw_e) - mx[r]) / den[r],  raw_e = pi[r] + pj[s_e]
//   dpi[r]  = sum_e alpha_e * (<v[s_e], dy[r]> - s_n[r]) * lrelu'(raw_e)
// dy[r] stays in registers; each lane adds w_e * (its share of the dot), the
// lane that owns edge e subtracts w_e * s_n[r] once, and one warp sum
// gives dpi.
template <typename V>
__global__ void __launch_bounds__(kThreads)
gat_bwd_dpi_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                   const float* __restrict__ pi, const float* __restrict__ pj,
                   const V* __restrict__ v, const float* __restrict__ mx,
                   const float* __restrict__ den,
                   const float* __restrict__ s_n, const V* __restrict__ dy,
                   float* __restrict__ dpi, int n_rows, int heads, int dv,
                   int log_g, float slope) {
  int row, h;
  if (!warp_task(n_rows, heads, row, h)) return;
  const Lanes L(log_g);
  const long long rh = (long long)row * heads + h;
  const int beg = indptr[row], end = indptr[row + 1];
  const float pir = pi[rh], mxr = mx[rh], denr = den[rh], snr = s_n[rh];
  float acc = 0.f;
  for (int c0 = 0; c0 == 0 || c0 < dv; c0 += L.g) {
    const int f = c0 + L.sub;
    const bool active = f < dv;
    const V dyr = active ? dy[rh * dv + f] : vzero<V>();
    for (int base = beg; base < end; base += 32) {
      const int e = base + L.lane;
      int my_col = 0;
      float my_w = 0.f;
      if (e < end) {
        my_col = col[e];
        const float raw = pir + pj[(long long)my_col * heads + h];
        const float alpha = expf(lrelu(raw, slope) - mxr) / denr;
        my_w = alpha * dlrelu(raw, slope);
        if (c0 == 0) acc -= my_w * snr;
      }
      const int cnt = min(32, end - base);
      for (int j0 = 0; j0 < cnt; j0 += L.p) {
        const int j = j0 + L.grp;
        const int c = __shfl_sync(kFull, my_col, j);
        const float wj = __shfl_sync(kFull, my_w, j);
        if (active && j < cnt)
          acc = fmaf(wj, vdot(v[((long long)c * heads + h) * dv + f], dyr),
                     acc);
      }
    }
  }
  acc = warp_sum(acc);
  if (L.lane == 0) dpi[rh] = acc;
}

// K5, replacing _gat_bwd_rev_kernel. Over the sender CSR, row s (col holds
// the receivers r_e):
//   dv[s]  = sum_e alpha_e * dy[r_e]
//   dpj[s] = sum_e alpha_e * (<v[s], dy[r_e]> - s_n[r_e]) * lrelu'(raw_e)
// v[s] stays in registers; each gathered dy row feeds both sums.
template <typename V>
__global__ void __launch_bounds__(kThreads)
gat_bwd_rev_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                   const float* __restrict__ pi, const float* __restrict__ pj,
                   const V* __restrict__ v, const float* __restrict__ mx,
                   const float* __restrict__ den,
                   const float* __restrict__ s_n, const V* __restrict__ dy,
                   float* __restrict__ dpj, V* __restrict__ dv_out,
                   int n_rows, int heads, int dv, int log_g, float slope) {
  int row, h;
  if (!warp_task(n_rows, heads, row, h)) return;
  const Lanes L(log_g);
  const long long sh = (long long)row * heads + h;
  const int beg = indptr[row], end = indptr[row + 1];
  const float pjs = pj[sh];
  float acc_pj = 0.f;
  for (int c0 = 0; c0 == 0 || c0 < dv; c0 += L.g) {
    const int f = c0 + L.sub;
    const bool active = f < dv;
    const V vs = active ? v[sh * dv + f] : vzero<V>();
    V acc = vzero<V>();
    for (int base = beg; base < end; base += 32) {
      const int e = base + L.lane;
      int my_r = 0;
      float my_a = 0.f, my_w = 0.f;
      if (e < end) {
        my_r = col[e];
        const long long rh = (long long)my_r * heads + h;
        const float raw = pi[rh] + pjs;
        my_a = expf(lrelu(raw, slope) - mx[rh]) / den[rh];
        my_w = my_a * dlrelu(raw, slope);
        if (c0 == 0) acc_pj -= my_w * s_n[rh];
      }
      const int cnt = min(32, end - base);
      for (int j0 = 0; j0 < cnt; j0 += L.p) {
        const int j = j0 + L.grp;
        const int r = __shfl_sync(kFull, my_r, j);
        const float aj = __shfl_sync(kFull, my_a, j);
        const float wj = __shfl_sync(kFull, my_w, j);
        if (active && j < cnt) {
          const V d = dy[((long long)r * heads + h) * dv + f];
          axpy(acc, aj, d);
          acc_pj = fmaf(wj, vdot(vs, d), acc_pj);
        }
      }
    }
    for (int off = L.g; off < 32; off <<= 1) add_xor(acc, off);
    if (active && L.grp == 0) dv_out[sh * dv + f] = acc;
  }
  acc_pj = warp_sum(acc_pj);
  if (L.lane == 0) dpj[sh] = acc_pj;
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
// across groups at the end. K10 sums da over every edge of the graph with
// no atomics: its warps stride over the (row, head) tasks with a stride that
// is a multiple of H, so each warp keeps one head's share of da in
// registers and writes it once; gatv2_da_reduce_kernel then sums the shares
// of each entry in a fixed order.

// K9, replacing _flash_gatv2_kernel. Over the receiver CSR, row r, head h:
//   m = max_e lg_e,  s = sum_e exp(lg_e - m),
//   num = sum_e exp(lg_e - m) k[s_e]
// with m = -inf, s = 0, num = 0 for a row without edges.
template <typename V, int NC>
__global__ void __launch_bounds__(kThreads)
gatv2_softmax_kernel(const int* __restrict__ indptr,
                     const int* __restrict__ col, const V* __restrict__ q,
                     const V* __restrict__ k, const float* __restrict__ a,
                     V* __restrict__ num, float* __restrict__ m,
                     float* __restrict__ s, int n_rows, int heads, int dv,
                     int log_g, float slope) {
  int row, h;
  if (!warp_task(n_rows, heads, row, h)) return;
  const Lanes L(log_g);
  const long long rh = (long long)row * heads + h;
  V qv[NC], av[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int f = L.sub + c * L.g;
    const bool on = f < dv;
    qv[c] = on ? q[rh * dv + f] : vzero<V>();
    av[c] = on ? load_a<V>(a, f, heads, h) : vzero<V>();
    acc[c] = vzero<V>();
  }
  float mg = -INFINITY, sg = 0.f;   // this edge group's running max and sum
  const int beg = indptr[row], end = indptr[row + 1];
  for (int base = beg; base < end; base += L.p) {   // warp-uniform trips
    const int e = base + L.grp;
    const bool valid = e < end;
    V kv[NC];
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) kv[c] = vzero<V>();
    if (valid) {
      const V* kr = k + ((long long)col[e] * heads + h) * dv;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int f = L.sub + c * L.g;
        if (f < dv) {
          kv[c] = kr[f];
          part += vdot(av[c], lrelu(vadd(qv[c], kv[c]), slope));
        }
      }
    }
    const float lg = group_sum(part, L.g);
    if (valid) {
      if (lg > mg) {
        const float sc = expf(mg - lg);   // 0 while mg is -inf
        sg *= sc;
#pragma unroll
        for (int c = 0; c < NC; ++c) vscale(acc[c], sc);
        mg = lg;
      }
      const float p = lg == -INFINITY ? 0.f : expf(lg - mg);
      sg += p;
#pragma unroll
      for (int c = 0; c < NC; ++c) axpy(acc[c], p, kv[c]);
    }
  }
  // merge the edge groups: rescale each to the row max, then add
  float mx = mg;
  for (int off = L.g; off < 32; off <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  const float sc = mg == -INFINITY ? 0.f : expf(mg - mx);
  sg *= sc;
#pragma unroll
  for (int c = 0; c < NC; ++c) vscale(acc[c], sc);
  for (int off = L.g; off < 32; off <<= 1) {
    sg += __shfl_xor_sync(kFull, sg, off);
#pragma unroll
    for (int c = 0; c < NC; ++c) add_xor(acc[c], off);
  }
  if (L.grp == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = L.sub + c * L.g;
      if (f < dv) num[rh * dv + f] = acc[c];
    }
  }
  if (L.lane == 0) {
    m[rh] = mx;
    s[rh] = sg;
  }
}

// K10, replacing _gatv2_bwd_fwd_kernel. Over the receiver CSR, row r:
//   alpha_e = exp(lg_e - mx[r]) / den[r],
//   dlg_e = alpha_e * (<k[s_e], dy[r]> - s_n[r]),
//   dq[r] = sum_e dlg_e * a * lrelu'(raw_e),   da += sum_e dlg_e * act_e.
// Warp gw takes tasks gw, gw + W, ... (W = the grid's warp count, a multiple
// of H), all of head h = gw % H, and writes its share of da[:, h] to
// da_part[gw, :] once at the end.
template <typename V, int NC>
__global__ void __launch_bounds__(kThreads)
gatv2_bwd_dq_kernel(const int* __restrict__ indptr,
                    const int* __restrict__ col, const V* __restrict__ q,
                    const V* __restrict__ k, const float* __restrict__ a,
                    const float* __restrict__ mx,
                    const float* __restrict__ den,
                    const float* __restrict__ s_n, const V* __restrict__ dy,
                    V* __restrict__ dq, V* __restrict__ da_part, int n_rows,
                    int heads, int dv, int log_g, float slope) {
  const Lanes L(log_g);
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  const long long gw =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int h = (int)(gw % heads);
  V av[NC], dav[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int f = L.sub + c * L.g;
    av[c] = f < dv ? load_a<V>(a, f, heads, h) : vzero<V>();
    dav[c] = vzero<V>();
  }
  const long long tasks = (long long)n_rows * heads;
  for (long long rh = gw; rh < tasks; rh += warps) {   // warp-uniform
    const int row = (int)(rh / heads);
    V qv[NC], dyv[NC], dqv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = L.sub + c * L.g;
      const bool on = f < dv;
      qv[c] = on ? q[rh * dv + f] : vzero<V>();
      dyv[c] = on ? dy[rh * dv + f] : vzero<V>();
      dqv[c] = vzero<V>();
    }
    const float mxr = mx[rh], denr = den[rh], snr = s_n[rh];
    const int beg = indptr[row], end = indptr[row + 1];
    for (int base = beg; base < end; base += L.p) {
      const int e = base + L.grp;
      const bool valid = e < end;
      V raw[NC];
      float plg = 0.f, pvd = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) raw[c] = vzero<V>();
      if (valid) {
        const V* kr = k + ((long long)col[e] * heads + h) * dv;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int f = L.sub + c * L.g;
          if (f < dv) {
            const V kf = kr[f];
            raw[c] = vadd(qv[c], kf);
            plg += vdot(av[c], lrelu(raw[c], slope));
            pvd += vdot(kf, dyv[c]);
          }
        }
      }
      group_sum2(plg, pvd, L.g);
      if (valid) {
        const float alpha = expf(plg - mxr) / denr;
        const float dlg = alpha * (pvd - snr);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          axpy_dlrelu(dqv[c], dlg, av[c], raw[c], slope);
          axpy(dav[c], dlg, lrelu(raw[c], slope));
        }
      }
    }
    for (int off = L.g; off < 32; off <<= 1) {
#pragma unroll
      for (int c = 0; c < NC; ++c) add_xor(dqv[c], off);
    }
    if (L.grp == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int f = L.sub + c * L.g;
        if (f < dv) dq[rh * dv + f] = dqv[c];
      }
    }
  }
  for (int off = L.g; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < NC; ++c) add_xor(dav[c], off);
  }
  if (L.grp == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = L.sub + c * L.g;
      if (f < dv) da_part[gw * dv + f] = dav[c];
    }
  }
}

// K10's second launch: da[f, h] = sum over the warps w of head h (w = h,
// h + H, ...) of da_part[w, f]. One warp per entry of da [O, H]; lane i
// adds the shares w = h + H * (i + 32 j) in order of j, then a fixed
// shuffle tree adds the lanes: the same order in every run.
__global__ void __launch_bounds__(kThreads)
gatv2_da_reduce_kernel(const float* __restrict__ da_part,
                       float* __restrict__ da, int warps, int heads, int o) {
  const long long j =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (j >= (long long)o * heads) return;   // warp-uniform
  const int f = (int)(j / heads), h = (int)(j % heads);
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (long long w = h + (long long)heads * lane; w < warps;
       w += 32LL * heads)
    acc += da_part[w * o + f];
  acc = warp_sum(acc);
  if (lane == 0) da[j] = acc;
}

// K11, replacing _gatv2_bwd_rev_kernel. Over the sender CSR, row s (col
// holds the receivers r_e):
//   dk[s] = sum_e dlg_e * a * lrelu'(raw_e) + alpha_e * dy[r_e]
// the logit half and the value half (values are k) in one sum. k[s] stays
// in registers; each gathered dy row feeds both <k[s], dy[r]> and the sum.
template <typename V, int NC>
__global__ void __launch_bounds__(kThreads)
gatv2_bwd_rev_kernel(const int* __restrict__ indptr,
                     const int* __restrict__ col, const V* __restrict__ q,
                     const V* __restrict__ k, const float* __restrict__ a,
                     const float* __restrict__ mx,
                     const float* __restrict__ den,
                     const float* __restrict__ s_n, const V* __restrict__ dy,
                     V* __restrict__ dk, int n_rows, int heads, int dv,
                     int log_g, float slope) {
  int row, h;
  if (!warp_task(n_rows, heads, row, h)) return;
  const Lanes L(log_g);
  const long long sh = (long long)row * heads + h;
  V kv[NC], av[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int f = L.sub + c * L.g;
    const bool on = f < dv;
    kv[c] = on ? k[sh * dv + f] : vzero<V>();
    av[c] = on ? load_a<V>(a, f, heads, h) : vzero<V>();
    acc[c] = vzero<V>();
  }
  const int beg = indptr[row], end = indptr[row + 1];
  for (int base = beg; base < end; base += L.p) {
    const int e = base + L.grp;
    const bool valid = e < end;
    V raw[NC], dyv[NC];
    float plg = 0.f, pvd = 0.f, mxr = 0.f, denr = 1.f, snr = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      raw[c] = vzero<V>();
      dyv[c] = vzero<V>();
    }
    if (valid) {
      const long long rh = (long long)col[e] * heads + h;
      mxr = mx[rh];
      denr = den[rh];
      snr = s_n[rh];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int f = L.sub + c * L.g;
        if (f < dv) {
          dyv[c] = dy[rh * dv + f];
          raw[c] = vadd(q[rh * dv + f], kv[c]);
          plg += vdot(av[c], lrelu(raw[c], slope));
          pvd += vdot(kv[c], dyv[c]);
        }
      }
    }
    group_sum2(plg, pvd, L.g);
    if (valid) {
      const float alpha = expf(plg - mxr) / denr;
      const float dlg = alpha * (pvd - snr);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        axpy_dlrelu(acc[c], dlg, av[c], raw[c], slope);
        axpy(acc[c], alpha, dyv[c]);
      }
    }
  }
  for (int off = L.g; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < NC; ++c) add_xor(acc[c], off);
  }
  if (L.grp == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = L.sub + c * L.g;
      if (f < dv) dk[sh * dv + f] = acc[c];
    }
  }
}

// ---- dot attention: K6, K7, K8 ---------------------------------------------
//
// Per edge e = (r, s) and head h:  raw = scale * <q[r], k[s]> (O wide),
// lg = lrelu(raw, slope), and the values v[s] (D wide; D need not equal O).
// The plain dot is slope 1: lrelu(raw, 1) == raw and its slope is 1
// everywhere, bit for bit. As in K9, each edge group of G lanes reduces its
// lanes' shares of the O-wide dot with shuffles before the exp. A lane keeps
// vector f = sub + c * G (c < NC) of the logit side (f < ov) and of the
// value side (f < dv) in registers, with G and NC sized for the wider side;
// both sides take float4 vectors only when O % 4 == 0 and D % 4 == 0.
//
// Bound on an H100: memory. K6 and K7 gather one k row (H*O floats) and
// one v row (H*D floats) per edge: 1 KB at H=4, O=D=32, and at H=1,
// O=D=128. K6 reads each once: the softmax is one pass, each edge group
// keeping a running max, sum and accumulator (rescaled when its max grows),
// merged across groups at the end. K7 and K8 recompute alpha from the
// finalised mx and den (4-byte per-node scalars) instead of reading a
// stored [E, H] array; K8 gathers the receivers' q and dy rows and their
// mx, den and s_n.

// K6, replacing _flash_dot_kernel. Over the receiver CSR, row r, head h:
//   m = max_e lg_e,  s = sum_e exp(lg_e - m),  num = sum_e exp(lg_e - m) v[s_e]
// with m = -inf, s = 0, num = 0 for a row without edges.
template <typename V, int NC>
__global__ void __launch_bounds__(kThreads)
dot_softmax_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                   const V* __restrict__ q, const V* __restrict__ k,
                   const V* __restrict__ v, V* __restrict__ num,
                   float* __restrict__ m, float* __restrict__ s, int n_rows,
                   int heads, int ov, int dv, int log_g, float scale,
                   float slope) {
  int row, h;
  if (!warp_task(n_rows, heads, row, h)) return;
  const Lanes L(log_g);
  const long long rh = (long long)row * heads + h;
  V qv[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int f = L.sub + c * L.g;
    qv[c] = f < ov ? q[rh * ov + f] : vzero<V>();
    acc[c] = vzero<V>();
  }
  float mg = -INFINITY, sg = 0.f;   // this edge group's running max and sum
  const int beg = indptr[row], end = indptr[row + 1];
  for (int base = beg; base < end; base += L.p) {   // warp-uniform trips
    const int e = base + L.grp;
    const bool valid = e < end;
    V vv[NC];   // the value row, loaded before the reduction to overlap it
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) vv[c] = vzero<V>();
    if (valid) {
      const long long src = (long long)col[e] * heads + h;
      const V* kr = k + src * ov;
      const V* vr = v + src * dv;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int f = L.sub + c * L.g;
        if (f < ov) part += vdot(qv[c], kr[f]);
        if (f < dv) vv[c] = vr[f];
      }
    }
    const float lg = lrelu(scale * group_sum(part, L.g), slope);
    if (valid) {
      if (lg > mg) {
        const float sc = expf(mg - lg);   // 0 while mg is -inf
        sg *= sc;
#pragma unroll
        for (int c = 0; c < NC; ++c) vscale(acc[c], sc);
        mg = lg;
      }
      const float p = lg == -INFINITY ? 0.f : expf(lg - mg);
      sg += p;
#pragma unroll
      for (int c = 0; c < NC; ++c) axpy(acc[c], p, vv[c]);
    }
  }
  // merge the edge groups: rescale each to the row max, then add
  float mx = mg;
  for (int off = L.g; off < 32; off <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  const float sc = mg == -INFINITY ? 0.f : expf(mg - mx);
  sg *= sc;
#pragma unroll
  for (int c = 0; c < NC; ++c) vscale(acc[c], sc);
  for (int off = L.g; off < 32; off <<= 1) {
    sg += __shfl_xor_sync(kFull, sg, off);
#pragma unroll
    for (int c = 0; c < NC; ++c) add_xor(acc[c], off);
  }
  if (L.grp == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = L.sub + c * L.g;
      if (f < dv) num[rh * dv + f] = acc[c];
    }
  }
  if (L.lane == 0) {
    m[rh] = mx;
    s[rh] = sg;
  }
}

// K7, replacing _dot_bwd_dq_kernel. Over the receiver CSR, row r:
//   alpha_e = exp(lg_e - mx[r]) / den[r],
//   dlg_e = alpha_e * (<v[s_e], dy[r]> - s_n[r]) * scale * lrelu'(raw_e),
//   dq[r] = sum_e dlg_e * k[s_e].
// q[r] and dy[r] stay in registers; each edge's two dots are reduced
// together in one shuffle tree.
template <typename V, int NC>
__global__ void __launch_bounds__(kThreads)
dot_bwd_dq_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                  const V* __restrict__ q, const V* __restrict__ k,
                  const V* __restrict__ v, const float* __restrict__ mx,
                  const float* __restrict__ den,
                  const float* __restrict__ s_n, const V* __restrict__ dy,
                  V* __restrict__ dq, int n_rows, int heads, int ov, int dv,
                  int log_g, float scale, float slope) {
  int row, h;
  if (!warp_task(n_rows, heads, row, h)) return;
  const Lanes L(log_g);
  const long long rh = (long long)row * heads + h;
  V qv[NC], dyv[NC], dqv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int f = L.sub + c * L.g;
    qv[c] = f < ov ? q[rh * ov + f] : vzero<V>();
    dyv[c] = f < dv ? dy[rh * dv + f] : vzero<V>();
    dqv[c] = vzero<V>();
  }
  const float mxr = mx[rh], denr = den[rh], snr = s_n[rh];
  const int beg = indptr[row], end = indptr[row + 1];
  for (int base = beg; base < end; base += L.p) {
    const int e = base + L.grp;
    const bool valid = e < end;
    V kv[NC];
    float plg = 0.f, pvd = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) kv[c] = vzero<V>();
    if (valid) {
      const long long src = (long long)col[e] * heads + h;
      const V* kr = k + src * ov;
      const V* vr = v + src * dv;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int f = L.sub + c * L.g;
        if (f < ov) {
          kv[c] = kr[f];
          plg += vdot(qv[c], kv[c]);
        }
        if (f < dv) pvd += vdot(vr[f], dyv[c]);
      }
    }
    group_sum2(plg, pvd, L.g);
    if (valid) {
      const float raw = scale * plg;
      const float alpha = expf(lrelu(raw, slope) - mxr) / denr;
      const float dlg = alpha * (pvd - snr) * scale * dlrelu(raw, slope);
#pragma unroll
      for (int c = 0; c < NC; ++c) axpy(dqv[c], dlg, kv[c]);
    }
  }
  for (int off = L.g; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < NC; ++c) add_xor(dqv[c], off);
  }
  if (L.grp == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = L.sub + c * L.g;
      if (f < ov) dq[rh * ov + f] = dqv[c];
    }
  }
}

// K8, replacing _dot_bwd_dkv_kernel. Over the sender CSR, row s (col holds
// the receivers r_e), with alpha_e and dlg_e as in K7:
//   dk[s] = sum_e dlg_e * q[r_e],   dv[s] = sum_e alpha_e * dy[r_e].
// k[s] and v[s] stay in registers; each gathered q row feeds the logit and
// dk, each gathered dy row <v[s], dy[r]> and dv.
template <typename V, int NC>
__global__ void __launch_bounds__(kThreads)
dot_bwd_rev_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                   const V* __restrict__ q, const V* __restrict__ k,
                   const V* __restrict__ v, const float* __restrict__ mx,
                   const float* __restrict__ den,
                   const float* __restrict__ s_n, const V* __restrict__ dy,
                   V* __restrict__ dk, V* __restrict__ dv_out, int n_rows,
                   int heads, int ov, int dv, int log_g, float scale,
                   float slope) {
  int row, h;
  if (!warp_task(n_rows, heads, row, h)) return;
  const Lanes L(log_g);
  const long long sh = (long long)row * heads + h;
  V kv[NC], vv[NC], dka[NC], dva[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int f = L.sub + c * L.g;
    kv[c] = f < ov ? k[sh * ov + f] : vzero<V>();
    vv[c] = f < dv ? v[sh * dv + f] : vzero<V>();
    dka[c] = vzero<V>();
    dva[c] = vzero<V>();
  }
  const int beg = indptr[row], end = indptr[row + 1];
  for (int base = beg; base < end; base += L.p) {
    const int e = base + L.grp;
    const bool valid = e < end;
    V qg[NC], dyg[NC];
    float plg = 0.f, pvd = 0.f, mxr = 0.f, denr = 1.f, snr = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      qg[c] = vzero<V>();
      dyg[c] = vzero<V>();
    }
    if (valid) {
      const long long rh = (long long)col[e] * heads + h;
      mxr = mx[rh];
      denr = den[rh];
      snr = s_n[rh];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int f = L.sub + c * L.g;
        if (f < ov) {
          qg[c] = q[rh * ov + f];
          plg += vdot(qg[c], kv[c]);
        }
        if (f < dv) {
          dyg[c] = dy[rh * dv + f];
          pvd += vdot(vv[c], dyg[c]);
        }
      }
    }
    group_sum2(plg, pvd, L.g);
    if (valid) {
      const float raw = scale * plg;
      const float alpha = expf(lrelu(raw, slope) - mxr) / denr;
      const float dlg = alpha * (pvd - snr) * scale * dlrelu(raw, slope);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        axpy(dka[c], dlg, qg[c]);
        axpy(dva[c], alpha, dyg[c]);
      }
    }
  }
  for (int off = L.g; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      add_xor(dka[c], off);
      add_xor(dva[c], off);
    }
  }
  if (L.grp == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = L.sub + c * L.g;
      if (f < ov) dk[sh * ov + f] = dka[c];
      if (f < dv) dv_out[sh * dv + f] = dva[c];
    }
  }
}

int log_group(int dv) {
  int lg = 0;
  while ((1 << lg) < dv && lg < 5) ++lg;
  return lg;
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

unsigned blocks_for(int n_rows, int heads) {
  const long long warps = (long long)n_rows * heads;
  return (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
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

template <typename V>
int launch_gatv2_softmax(const int* indptr, const int* col, const float* q,
                         const float* k, const float* a, float* num, float* m,
                         float* s, int n_rows, int heads, int dv, float slope,
                         cudaStream_t st) {
  const unsigned nb = blocks_for(n_rows, heads);
  return with_chunks(dv, [&](auto nc) {
    gatv2_softmax_kernel<V, decltype(nc)::value><<<nb, kThreads, 0, st>>>(
        indptr, col, reinterpret_cast<const V*>(q),
        reinterpret_cast<const V*>(k), a, reinterpret_cast<V*>(num), m, s,
        n_rows, heads, dv, log_group(dv), slope);
  });
}

template <typename V>
int launch_gatv2_bwd_dq(const int* indptr, const int* col, const float* q,
                        const float* k, const float* a, const float* mx,
                        const float* den, const float* s_n, const float* dy,
                        float* dq, float* da_part, int n_rows, int heads,
                        int dv, unsigned blocks, float slope,
                        cudaStream_t st) {
  return with_chunks(dv, [&](auto nc) {
    gatv2_bwd_dq_kernel<V, decltype(nc)::value><<<blocks, kThreads, 0, st>>>(
        indptr, col, reinterpret_cast<const V*>(q),
        reinterpret_cast<const V*>(k), a, mx, den, s_n,
        reinterpret_cast<const V*>(dy), reinterpret_cast<V*>(dq),
        reinterpret_cast<V*>(da_part), n_rows, heads, dv, log_group(dv),
        slope);
  });
}

template <typename V>
int launch_gatv2_bwd_rev(const int* indptr, const int* col, const float* q,
                         const float* k, const float* a, const float* mx,
                         const float* den, const float* s_n, const float* dy,
                         float* dk, int n_rows, int heads, int dv, float slope,
                         cudaStream_t st) {
  const unsigned nb = blocks_for(n_rows, heads);
  return with_chunks(dv, [&](auto nc) {
    gatv2_bwd_rev_kernel<V, decltype(nc)::value><<<nb, kThreads, 0, st>>>(
        indptr, col, reinterpret_cast<const V*>(q),
        reinterpret_cast<const V*>(k), a, mx, den, s_n,
        reinterpret_cast<const V*>(dy), reinterpret_cast<V*>(dk), n_rows,
        heads, dv, log_group(dv), slope);
  });
}

// The dot kernels size G and NC for the wider of the logit side (ov
// vectors) and the value side (dv vectors).
template <typename V>
int launch_dot_softmax(const int* indptr, const int* col, const float* q,
                       const float* k, const float* v, float* num, float* m,
                       float* s, int n_rows, int heads, int ov, int dv,
                       float scale, float slope, cudaStream_t st) {
  const unsigned nb = blocks_for(n_rows, heads);
  const int wide = ov > dv ? ov : dv;
  return with_chunks(wide, [&](auto nc) {
    dot_softmax_kernel<V, decltype(nc)::value><<<nb, kThreads, 0, st>>>(
        indptr, col, reinterpret_cast<const V*>(q),
        reinterpret_cast<const V*>(k), reinterpret_cast<const V*>(v),
        reinterpret_cast<V*>(num), m, s, n_rows, heads, ov, dv,
        log_group(wide), scale, slope);
  });
}

template <typename V>
int launch_dot_bwd_dq(const int* indptr, const int* col, const float* q,
                      const float* k, const float* v, const float* mx,
                      const float* den, const float* s_n, const float* dy,
                      float* dq, int n_rows, int heads, int ov, int dv,
                      float scale, float slope, cudaStream_t st) {
  const unsigned nb = blocks_for(n_rows, heads);
  const int wide = ov > dv ? ov : dv;
  return with_chunks(wide, [&](auto nc) {
    dot_bwd_dq_kernel<V, decltype(nc)::value><<<nb, kThreads, 0, st>>>(
        indptr, col, reinterpret_cast<const V*>(q),
        reinterpret_cast<const V*>(k), reinterpret_cast<const V*>(v), mx,
        den, s_n, reinterpret_cast<const V*>(dy), reinterpret_cast<V*>(dq),
        n_rows, heads, ov, dv, log_group(wide), scale, slope);
  });
}

template <typename V>
int launch_dot_bwd_rev(const int* indptr, const int* col, const float* q,
                       const float* k, const float* v, const float* mx,
                       const float* den, const float* s_n, const float* dy,
                       float* dk, float* dv_out, int n_rows, int heads, int ov,
                       int dv, float scale, float slope, cudaStream_t st) {
  const unsigned nb = blocks_for(n_rows, heads);
  const int wide = ov > dv ? ov : dv;
  return with_chunks(wide, [&](auto nc) {
    dot_bwd_rev_kernel<V, decltype(nc)::value><<<nb, kThreads, 0, st>>>(
        indptr, col, reinterpret_cast<const V*>(q),
        reinterpret_cast<const V*>(k), reinterpret_cast<const V*>(v), mx,
        den, s_n, reinterpret_cast<const V*>(dy), reinterpret_cast<V*>(dk),
        reinterpret_cast<V*>(dv_out), n_rows, heads, ov, dv, log_group(wide),
        scale, slope);
  });
}

bool dot_float4(int o, int d, std::initializer_list<const void*> rows) {
  if (o % 4 != 0 || d % 4 != 0) return false;
  for (const void* p : rows)
    if (!aligned16(p)) return false;
  return true;
}

}  // namespace

// Every function returns cudaGetLastError() after the launch (0 on
// success). The caller allocates every output, makes sure n_rows > 0 and
// heads > 0, and that rows * heads warps fit one grid (n_rows * heads <
// 2^34).
extern "C" {

// K12. num [n_rows, H, d], m and s [n_rows, H]. col == NULL: values are
// per edge [E, H, d]; else per node, indexed by col. mask may be NULL.
int edge_softmax_f32(const int* indptr, const int* col, const float* lg,
                     const float* mask, const float* v, float* num, float* m,
                     float* s, int n_rows, int heads, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = blocks_for(n_rows, heads);
  if (d % 4 == 0 && aligned16(v) && aligned16(num)) {
    const int dv = d / 4;
    edge_softmax_kernel<float4><<<nb, kThreads, 0, st>>>(
        indptr, col, lg, mask, reinterpret_cast<const float4*>(v),
        reinterpret_cast<float4*>(num), m, s, n_rows, heads, dv,
        log_group(dv));
  } else {
    edge_softmax_kernel<float><<<nb, kThreads, 0, st>>>(
        indptr, col, lg, mask, v, num, m, s, n_rows, heads, d, log_group(d));
  }
  return static_cast<int>(cudaGetLastError());
}

// K3. pi [n_rows, H], pj [n_src, H], v [n_src, H, d]; outputs as K12.
int gat_softmax_f32(const int* indptr, const int* col, const float* pi,
                    const float* pj, const float* v, float* num, float* m,
                    float* s, int n_rows, int heads, int d, float slope,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = blocks_for(n_rows, heads);
  if (d % 4 == 0 && aligned16(v) && aligned16(num)) {
    const int dv = d / 4;
    gat_softmax_kernel<float4><<<nb, kThreads, 0, st>>>(
        indptr, col, pi, pj, reinterpret_cast<const float4*>(v),
        reinterpret_cast<float4*>(num), m, s, n_rows, heads, dv,
        log_group(dv), slope);
  } else {
    gat_softmax_kernel<float><<<nb, kThreads, 0, st>>>(
        indptr, col, pi, pj, v, num, m, s, n_rows, heads, d, log_group(d),
        slope);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4. Over the receiver CSR of n_rows receivers: dpi [n_rows, H].
int gat_bwd_dpi_f32(const int* indptr, const int* col, const float* pi,
                    const float* pj, const float* v, const float* mx,
                    const float* den, const float* s_n, const float* dy,
                    float* dpi, int n_rows, int heads, int d, float slope,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = blocks_for(n_rows, heads);
  if (d % 4 == 0 && aligned16(v) && aligned16(dy)) {
    const int dv = d / 4;
    gat_bwd_dpi_kernel<float4><<<nb, kThreads, 0, st>>>(
        indptr, col, pi, pj, reinterpret_cast<const float4*>(v), mx, den, s_n,
        reinterpret_cast<const float4*>(dy), dpi, n_rows, heads, dv,
        log_group(dv), slope);
  } else {
    gat_bwd_dpi_kernel<float><<<nb, kThreads, 0, st>>>(
        indptr, col, pi, pj, v, mx, den, s_n, dy, dpi, n_rows, heads, d,
        log_group(d), slope);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5. Over the sender CSR of n_rows senders: dpj [n_rows, H] and
// dv [n_rows, H, d].
int gat_bwd_rev_f32(const int* indptr, const int* col, const float* pi,
                    const float* pj, const float* v, const float* mx,
                    const float* den, const float* s_n, const float* dy,
                    float* dpj, float* dv, int n_rows, int heads, int d,
                    float slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = blocks_for(n_rows, heads);
  if (d % 4 == 0 && aligned16(v) && aligned16(dy) && aligned16(dv)) {
    const int dvec = d / 4;
    gat_bwd_rev_kernel<float4><<<nb, kThreads, 0, st>>>(
        indptr, col, pi, pj, reinterpret_cast<const float4*>(v), mx, den, s_n,
        reinterpret_cast<const float4*>(dy), dpj,
        reinterpret_cast<float4*>(dv), n_rows, heads, dvec, log_group(dvec),
        slope);
  } else {
    gat_bwd_rev_kernel<float><<<nb, kThreads, 0, st>>>(
        indptr, col, pi, pj, v, mx, den, s_n, dy, dpj, dv, n_rows, heads, d,
        log_group(d), slope);
  }
  return static_cast<int>(cudaGetLastError());
}

// K9. Over the receiver CSR of n_rows receivers: q [n_rows, H, d],
// k [n_src, H, d], a [d, H]; num [n_rows, H, d], m and s [n_rows, H].
// float4 rows take d <= 1024, scalar rows d <= 256; wider returns
// cudaErrorInvalidValue.
int gatv2_softmax_f32(const int* indptr, const int* col, const float* q,
                      const float* k, const float* a, float* num, float* m,
                      float* s, int n_rows, int heads, int d, float slope,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(num))
    return launch_gatv2_softmax<float4>(indptr, col, q, k, a, num, m, s,
                                        n_rows, heads, d / 4, slope, st);
  return launch_gatv2_softmax<float>(indptr, col, q, k, a, num, m, s, n_rows,
                                     heads, d, slope, st);
}

// K10, first launch. Over the receiver CSR: dq [n_rows, H, d] and
// da_part [8 * blocks, d], each warp's share of da. 8 * blocks must be a
// multiple of H. Widths as K9.
int gatv2_bwd_dq_f32(const int* indptr, const int* col, const float* q,
                     const float* k, const float* a, const float* mx,
                     const float* den, const float* s_n, const float* dy,
                     float* dq, float* da_part, int n_rows, int heads, int d,
                     int blocks, float slope, void* stream) {
  if (blocks <= 0 || (kWarpsPerBlock * (long long)blocks) % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(dy) &&
      aligned16(dq) && aligned16(da_part))
    return launch_gatv2_bwd_dq<float4>(indptr, col, q, k, a, mx, den, s_n, dy,
                                       dq, da_part, n_rows, heads, d / 4,
                                       (unsigned)blocks, slope, st);
  return launch_gatv2_bwd_dq<float>(indptr, col, q, k, a, mx, den, s_n, dy,
                                    dq, da_part, n_rows, heads, d,
                                    (unsigned)blocks, slope, st);
}

// K10's blocks that stay resident on one SM at once, for rows of d floats
// (vec: float4 loads), so that its grid can be one wave: its warps stride
// over the tasks, and a second, partial wave would leave SMs idle at the
// end. Returns -1 for rows wider than the kernels take.
int gatv2_bwd_dq_blocks_per_sm(int d, int vec) {
  int per_sm = -1;
  const int dv = vec ? d / 4 : d;
  const int rc = with_chunks(dv, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    if (vec)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gatv2_bwd_dq_kernel<float4, NC>, kThreads, 0);
    else
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gatv2_bwd_dq_kernel<float, NC>, kThreads, 0);
  });
  return rc == 0 ? per_sm : -1;
}

// K10, second launch: da [d, H] from da_part [warps, d].
int gatv2_da_reduce_f32(const float* da_part, float* da, int warps, int heads,
                        int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = blocks_for(d, heads);
  gatv2_da_reduce_kernel<<<nb, kThreads, 0, st>>>(da_part, da, warps, heads,
                                                  d);
  return static_cast<int>(cudaGetLastError());
}

// K11. Over the sender CSR of n_rows senders: dk [n_rows, H, d]. Widths as
// K9.
int gatv2_bwd_rev_f32(const int* indptr, const int* col, const float* q,
                      const float* k, const float* a, const float* mx,
                      const float* den, const float* s_n, const float* dy,
                      float* dk, int n_rows, int heads, int d, float slope,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(dy) &&
      aligned16(dk))
    return launch_gatv2_bwd_rev<float4>(indptr, col, q, k, a, mx, den, s_n,
                                        dy, dk, n_rows, heads, d / 4, slope,
                                        st);
  return launch_gatv2_bwd_rev<float>(indptr, col, q, k, a, mx, den, s_n, dy,
                                     dk, n_rows, heads, d, slope, st);
}

// K6. Over the receiver CSR of n_rows receivers: q [n_rows, H, o],
// k [n_src, H, o], v [n_src, H, d]; num [n_rows, H, d], m and s
// [n_rows, H]. slope 1 is the plain dot. float4 vectors when o and d are
// multiples of 4 and every row pointer is 16-byte aligned; the wider of o
// and d may be 1024 floats with float4 vectors, 256 without; wider returns
// cudaErrorInvalidValue.
int dot_softmax_f32(const int* indptr, const int* col, const float* q,
                    const float* k, const float* v, float* num, float* m,
                    float* s, int n_rows, int heads, int o, int d, float scale,
                    float slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dot_float4(o, d, {q, k, v, num}))
    return launch_dot_softmax<float4>(indptr, col, q, k, v, num, m, s, n_rows,
                                      heads, o / 4, d / 4, scale, slope, st);
  return launch_dot_softmax<float>(indptr, col, q, k, v, num, m, s, n_rows,
                                   heads, o, d, scale, slope, st);
}

// K7. Over the receiver CSR: dq [n_rows, H, o]. mx, den, s_n and dy
// [n_rows, H(, d)] are the receivers'. Widths as K6.
int dot_bwd_dq_f32(const int* indptr, const int* col, const float* q,
                   const float* k, const float* v, const float* mx,
                   const float* den, const float* s_n, const float* dy,
                   float* dq, int n_rows, int heads, int o, int d, float scale,
                   float slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dot_float4(o, d, {q, k, v, dy, dq}))
    return launch_dot_bwd_dq<float4>(indptr, col, q, k, v, mx, den, s_n, dy,
                                     dq, n_rows, heads, o / 4, d / 4, scale,
                                     slope, st);
  return launch_dot_bwd_dq<float>(indptr, col, q, k, v, mx, den, s_n, dy, dq,
                                  n_rows, heads, o, d, scale, slope, st);
}

// K8. Over the sender CSR of n_rows senders: dk [n_rows, H, o] and
// dv [n_rows, H, d]; q, mx, den, s_n and dy are the receivers'. Widths as
// K6.
int dot_bwd_rev_f32(const int* indptr, const int* col, const float* q,
                    const float* k, const float* v, const float* mx,
                    const float* den, const float* s_n, const float* dy,
                    float* dk, float* dv, int n_rows, int heads, int o, int d,
                    float scale, float slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dot_float4(o, d, {q, k, v, dy, dk, dv}))
    return launch_dot_bwd_rev<float4>(indptr, col, q, k, v, mx, den, s_n, dy,
                                      dk, dv, n_rows, heads, o / 4, d / 4,
                                      scale, slope, st);
  return launch_dot_bwd_rev<float>(indptr, col, q, k, v, mx, den, s_n, dy, dk,
                                   dv, n_rows, heads, o, d, scale, slope, st);
}

const char* gnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
