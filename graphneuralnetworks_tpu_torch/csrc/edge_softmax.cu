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
// Layout of the work (K3-K5, K9, K10, K12; the dot kernels K6-K8 take rows
// and strips of their own, see the dot section, and K11 takes K8's rows):
// one warp owns one (row, head) pair, so all heads run in one launch and
// every output entry is written once by one warp, in a fixed order, with
// no atomics. As in spmm.cu, a head's D floats are split into vectors
// (float4 when D % 4 == 0 and the pointers are 16-byte aligned), a warp
// splits into groups of G lanes (G = the vector count, rounded up to a
// power of two, at most 32) that take interleaved edges, and rows wider
// than 32 vectors loop over chunks. K3's
// and K12's softmax takes two passes over a row's edges: the row max of the
// logits first (scalars only), then exp(logit - max), their sum and the
// weighted sum of value rows. So no running rescale is needed, and the
// value rows are read once per chunk.
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

// ---- dot attention: K6, K7, K8 ---------------------------------------------
//
// Per edge e = (r, s) and head h:  raw = scale * <q[r], k[s]> (O wide),
// lg = lrelu(raw, slope), and the values v[s] (D wide; D need not equal O).
// The plain dot is slope 1: lrelu(raw, 1) == raw and its slope is 1
// everywhere, bit for bit. A head's rows split into vectors (float4 only
// when O % 4 == 0 and D % 4 == 0) and edge groups of G lanes (G = the wider
// side's vector count rounded up to a power of two, at most 32; wider rows
// in NC register chunks of G vectors); an edge group reduces its lanes'
// shares of a dot with shuffles.
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
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_g);
    const bool live = row < n_rows;
    const long long rh = (long long)row * heads + h;
    V qv[NC], acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = sub + c * g;
      qv[c] = live && f < ov ? q[rh * ov + f] : vzero<V>();
      acc[c] = vzero<V>();
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
          for (int cc = 0; cc < NC; ++cc) lg[u] += vdot(qv[cc], kg[u][cc]);
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
          for (int cc = 0; cc < NC; ++cc) axpy(acc[cc], pe, vg[u][cc]);
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
        if (f < dv) num[rh * dv + f] = acc[cc];
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
// dy[r] and the row's mx, den and s_n stay in registers.
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
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_g);
    const bool live = row < n_rows;
    const long long rh = (long long)row * heads + h;
    V qv[NC], dyv[NC], dqa[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = sub + c * g;
      qv[c] = live && !given && f < ov ? q[rh * ov + f] : vzero<V>();
      dyv[c] = live && f < dv ? dy[rh * dv + f] : vzero<V>();
      dqa[c] = vzero<V>();
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
          for (int cc = 0; cc < NC; ++cc) pvd[u] += vdot(vg[u][cc], dyv[cc]);
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
            for (int cc = 0; cc < NC; ++cc) plg[u] += vdot(qv[cc], kg[u][cc]);
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
          for (int cc = 0; cc < NC; ++cc) axpy(dqa[cc], dlg, kg[u][cc]);
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
        if (f < ov) dq[rh * ov + f] = dqa[cc];
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
    const V av = live && active ? a[((long long)row * heads + h) * width + f]
                                : vzero<V>();
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
        for (int u = 0; u < U; ++u) dt[u] = vdot(av, bg[u]);
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
    V acc = vzero<V>();
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
        for (int u = 0; u < U; ++u) axpy(acc, wj[u], xg[u]);
      }
      c = nc;
      wt = nwt;
    }
    for (int off = g; off < S.seg; off <<= 1) add_xor(acc, off);
    if (live && active && S.grp == 0)
      out[((long long)row * heads + h) * width + f] = acc;
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
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_g);
    const bool live = row < n_rows;
    const long long sh = (long long)row * heads + h;
    V kv[NC], vv[NC], dka[NC], dva[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = sub + c * g;
      kv[c] = live && f < ov ? k[sh * ov + f] : vzero<V>();
      vv[c] = live && f < dv ? v[sh * dv + f] : vzero<V>();
      dka[c] = vzero<V>();
      dva[c] = vzero<V>();
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
            plg[u] += vdot(qg[u][cc], kv[cc]);
            pvd[u] += vdot(vv[cc], dyg[u][cc]);
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
            axpy(dka[cc], dlg, qg[u][cc]);
            axpy(dva[cc], alpha, dyg[u][cc]);
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
        if (f < ov) dk[sh * ov + f] = dka[cc];
        if (f < dv) dv_out[sh * dv + f] = dva[cc];
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
  V av[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int f = sub + c * g;
    av[c] = f < dv ? load_a<V>(a, f, heads, h) : vzero<V>();
  }
  walk_rows(indptr, rb, lane, n_rows, log_rows,
            [&](int row, int beg, int len, int longest, int log_seg) {
    const Seg S(lane, log_seg, log_g);
    const bool live = row < n_rows;
    const long long sh = (long long)row * heads + h;
    V kv[NC], acc[NC];
    // k and dk stream past the L2 (evict-first), which keeps the head's
    // slices of q and dy that the pass gathers from
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = sub + c * g;
      kv[c] = live && f < dv ? __ldcs(k + sh * dv + f) : vzero<V>();
      acc[c] = vzero<V>();
    }
    int c = S.sl < len ? col[beg + S.sl] : 0;   // the first window
    for (int w0 = 0; w0 < longest; w0 += S.seg) {   // warp-uniform trips
      const int nc =
          w0 + S.seg + S.sl < len ? col[beg + w0 + S.seg + S.sl] : 0;
      const int cnt = min(S.seg, longest - w0);
      for (int j0 = 0; j0 < cnt; j0 += S.p * U) {   // warp-uniform trips
        V raw[U][NC], dyg[U][NC];
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
            raw[u][cc] = ok[u] && f < dv ? q[rh * dv + f] : vzero<V>();
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
            pvd[u] += vdot(kv[cc], dyg[u][cc]);
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
            axpy(acc[cc], alpha, dyg[u][cc]);
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
        if (f < dv) __stcs(dk + sh * dv + f, acc[cc]);
      }
    }
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
// picks.
template <typename Pick, typename Go>
int with_row_instances(int wide, int unroll, int reg_cap, Go&& go) {
  bool launched = false;
  const int rc = with_chunks(wide, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    auto pick = [&](auto un, auto cap) {
      constexpr int UU = decltype(un)::value, C = decltype(cap)::value;
#ifdef GNN_SWEEP
      constexpr bool built = (UU == 1 || NC * UU <= 4) && (C == 0 || NC <= 2);
#else
      constexpr bool built = Pick::holds(NC, UU, C);
#endif
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
// uncapped and at 64 registers; the shipped library: Pick::kUnroll at
// Pick::kCap). Returns cudaGetLastError() after it, or
// cudaErrorInvalidValue with nothing launched.
template <typename Pick, typename Go>
int with_strip_instances(int unroll, int reg_cap, Go&& go) {
  bool launched = false;
  auto pick = [&](auto un, auto cap) {
    constexpr int UU = decltype(un)::value, C = decltype(cap)::value;
#ifdef GNN_SWEEP
    constexpr bool built = true;
#else
    constexpr bool built = Pick::kUnroll == UU && Pick::kCap == C;
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
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The shipped instances, from chip_smoke.py --sweep (PERF.md §6), as
// ops/cuda/edge_softmax.py's _DOT_*, _K8_* and _K11_* constants pick them:
// rows of one register chunk take edges in flight at 64 registers (K8 and
// K11 2; K6 and K7 4 for groups of a 128-byte line or more, 2 for narrower
// ones), wider rows one edge, uncapped (two chunks of two edges at 64
// registers spill); strips 4 gathers in flight, uncapped.
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
struct StripPick {
  static constexpr int kUnroll = 4;
  static constexpr int kCap = 0;
};

// log2 of the vectors of one 128-byte line: a strip, and the lanes of its
// edge groups.
template <typename V>
constexpr int log_line() {
  return sizeof(V) == 16 ? 3 : 5;
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

template <typename V>
int launch_dot_softmax(const int* indptr, const int* col, const float* q,
                       const float* k, const float* v, float* num, float* m,
                       float* s, float* raw, float* scratch, int n_rows,
                       int heads, int ov, int dv, long long n_edges,
                       int strips, int log_rows, int unroll, int reg_cap,
                       float scale, float slope, cudaStream_t st) {
  const V* qv = reinterpret_cast<const V*>(q);
  const V* kv = reinterpret_cast<const V*>(k);
  const V* vv = reinterpret_cast<const V*>(v);
  V* numv = reinterpret_cast<V*>(num);
  const int wide = ov > dv ? ov : dv;
  if (!strips) {
    const int lg = log_group(wide);
    if (!dot_layout_ok(lg, log_rows, heads))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid = row_grid(n_rows, log_rows, heads);
    return with_row_instances<RecvPick>(
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
  return with_strip_instances<StripPick>(
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

template <typename V>
int launch_dot_bwd_dq(const int* indptr, const int* col, const float* q,
                      const float* k, const float* v, const float* mx,
                      const float* den, const float* s_n, const float* dy,
                      const float* raw, float* dq, float* scratch,
                      int n_rows, int heads, int ov, int dv,
                      long long n_edges, int strips, int log_rows, int unroll,
                      int reg_cap, float scale, float slope,
                      cudaStream_t st) {
  const V* qv = reinterpret_cast<const V*>(q);
  const V* kv = reinterpret_cast<const V*>(k);
  const V* vv = reinterpret_cast<const V*>(v);
  const V* dyv = reinterpret_cast<const V*>(dy);
  V* dqv = reinterpret_cast<V*>(dq);
  const int wide = ov > dv ? ov : dv;
  if (!strips) {
    const int lg = log_group(wide);
    if (!dot_layout_ok(lg, log_rows, heads))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid = row_grid(n_rows, log_rows, heads);
    return with_row_instances<RecvPick>(
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
  return with_strip_instances<StripPick>(
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
// holds.
template <typename V>
int launch_dot_bwd_rev(const int* indptr, const int* col, const float* q,
                       const float* k, const float* v, const float* mx,
                       const float* den, const float* s_n, const float* dy,
                       float* dk, float* dv_out, int n_rows, int heads, int ov,
                       int dv, int log_rows, int unroll, int reg_cap,
                       float scale, float slope, cudaStream_t st) {
  const int wide = ov > dv ? ov : dv;
  const int lg = log_group(wide);
  if (!dot_layout_ok(lg, log_rows, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = row_grid(n_rows, log_rows, heads);
  return with_row_instances<K8Pick>(
      wide, unroll, reg_cap, [&](auto nc, auto un, auto minb) {
        dot_bwd_rev_kernel<V, decltype(nc)::value, decltype(un)::value,
                           decltype(minb)::value><<<grid, kThreads, 0, st>>>(
            indptr, col, reinterpret_cast<const V*>(q),
            reinterpret_cast<const V*>(k), reinterpret_cast<const V*>(v), mx,
            den, s_n, reinterpret_cast<const V*>(dy),
            reinterpret_cast<V*>(dk), reinterpret_cast<V*>(dv_out), n_rows,
            heads, ov, dv, lg, log_rows, scale, slope);
      });
}

// K11 in rows (see gatv2_bwd_rev_kernel), at the instances
// with_row_instances holds.
template <typename V>
int launch_gatv2_bwd_rev(const int* indptr, const int* col, const float* q,
                         const float* k, const float* a, const float* mx,
                         const float* den, const float* s_n,
                         const float* stats, const float* dy, float* dk,
                         int n_rows, int heads, int dv,
                         int log_rows, int unroll, int reg_cap, float slope,
                         cudaStream_t st) {
  const int lg = log_group(dv);
  if (!dot_layout_ok(lg, log_rows, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = row_grid(n_rows, log_rows, heads);
  return with_row_instances<K11Pick>(
      dv, unroll, reg_cap, [&](auto nc, auto un, auto minb) {
        gatv2_bwd_rev_kernel<V, decltype(nc)::value, decltype(un)::value,
                             decltype(minb)::value>
            <<<grid, kThreads, 0, st>>>(
                indptr, col, reinterpret_cast<const V*>(q),
                reinterpret_cast<const V*>(k), a, mx, den, s_n,
                reinterpret_cast<const float4*>(stats),
                reinterpret_cast<const V*>(dy), reinterpret_cast<V*>(dk),
                n_rows, heads, dv, lg, log_rows, slope);
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

const char* gnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
