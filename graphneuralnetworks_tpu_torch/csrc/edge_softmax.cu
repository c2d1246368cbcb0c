// Edge softmax over a node's in-edges, with aggregation: K3, K4, K5 and K12,
// float32, for sm_90a.
//
// Replaces graphneuralnetworks_tpu/ops/pallas/edge_softmax.py:
//   K12 _flash_kernel         softmax of given per-edge logits, numerator
//                             times a dropout mask, sum of node or edge values
//   K3  _flash_gat_kernel     the same with GAT's logits
//                             lrelu(pi[r] + pj[s]) computed in the kernel
//   K4  _gat_bwd_dpi_kernel   GAT backward, dpi, over the receiver CSR
//   K5  _gat_bwd_rev_kernel   GAT backward, dpj and dv, over the sender CSR
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
// and rows wider than 32 vectors loop over chunks. The softmax takes two
// passes over a row's edges: the row max of the logits first (scalars
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

const char* gnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
