// Per-row max or min over a CSR (segment max): K14 and its backward, float32,
// for sm_90a.
//
// Replaces graphneuralnetworks_tpu/ops/pallas/edge_softmax.py:_segmax_kernel
// (reached through segment_max_grouped: the running max of [E, H] logits per
// receiver block, by a one-hot mask over 128x512 blocks and a lane reduction
// per head).
//
//   out[r, f]   = max (or min) of data[e, f] over e in [indptr[r], indptr[r+1])
//   ddata[e, f] = dy[r, f] * (data[e, f] == out[r, f]) / #{e' of row r:
//                 data[e', f] == out[r, f]}
//
// Layouts (row-major, contiguous): indptr int32[n_rows + 1]; data [rows, F]
// whose rows are the CSR's entries in order (the port's edges are stored in
// receiver order, nodes of a batch in graph order), so entry e is row e of
// data and nothing is gathered; out, dy [n_rows, F]; ddata [rows, F]. A row
// without entries gets -inf (+inf for min), as the TPU kernel returns them.
//
// NaN: an entry that is NaN makes its output NaN, as jnp.maximum and
// torch.amax do (fmaxf / fminf would drop it). The backward gives such an
// output's entries no gradient (no entry equals NaN). A tie splits the
// cotangent evenly, the gradient JAX and PyTorch both give.
//
// Layout of the work: one warp owns one (row, chunk of 32 column vectors).
// Columns go to lanes as float4 when F % 4 == 0 and the pointers are 16-byte
// aligned, else as scalars. A row narrower than 32 vectors splits the warp
// into edge groups of G lanes (G = the vector count rounded up to a power of
// two) that take interleaved entries; the groups' partial results meet by
// shuffles at the end. Each output is written by one lane, each entry of
// ddata by one lane, with no atomics: the same bits in every run. Max and min
// are one loop with the comparison reversed, not -max(-x), which would cost
// two more passes over [rows, F].
//
// Bound on an H100: memory. The forward reads each entry once (4 bytes
// against one comparison) and writes each output once; the rows are
// contiguous, so the no-L2-reuse traffic is the compulsory traffic. The
// backward counts the ties of a row in a first sweep and writes ddata in a
// second; the second sweep re-reads the row's entries, which the first just
// brought into L1/L2 (a row of 15 entries at F = 128 is 7.5 KB).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

template <typename V> __device__ __forceinline__ V vfill(float a);
template <> __device__ __forceinline__ float vfill<float>(float a) { return a; }
template <> __device__ __forceinline__ float4 vfill<float4>(float a) {
  return make_float4(a, a, a, a);
}

// The running max (min) with NaN kept: b wins when it is larger (smaller)
// or NaN; once the running value is NaN, no comparison with it is true.
template <bool kMin>
__device__ __forceinline__ float pick(float a, float b) {
  const bool take = kMin ? (b < a) : (b > a);
  return (take || b != b) ? b : a;
}
template <bool kMin>
__device__ __forceinline__ float4 pick(const float4& a, const float4& b) {
  return make_float4(pick<kMin>(a.x, b.x), pick<kMin>(a.y, b.y),
                     pick<kMin>(a.z, b.z), pick<kMin>(a.w, b.w));
}

__device__ __forceinline__ float shfl(float v, int off) {
  return __shfl_xor_sync(kFull, v, off);
}
__device__ __forceinline__ float4 shfl(const float4& v, int off) {
  return make_float4(shfl(v.x, off), shfl(v.y, off), shfl(v.z, off),
                     shfl(v.w, off));
}

// 1 where the entry equals the row's extreme, else 0
__device__ __forceinline__ float hit(float d, float o) {
  return d == o ? 1.f : 0.f;
}
__device__ __forceinline__ float4 hit(const float4& d, const float4& o) {
  return make_float4(hit(d.x, o.x), hit(d.y, o.y), hit(d.z, o.z),
                     hit(d.w, o.w));
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// dy / count, 0 where no entry ties (a NaN output)
__device__ __forceinline__ float share(float dy, float cnt) {
  return cnt > 0.f ? dy / cnt : 0.f;
}
__device__ __forceinline__ float4 share(const float4& dy, const float4& cnt) {
  return make_float4(share(dy.x, cnt.x), share(dy.y, cnt.y),
                     share(dy.z, cnt.z), share(dy.w, cnt.w));
}

__device__ __forceinline__ float route(float d, float o, float s) {
  return d == o ? s : 0.f;
}
__device__ __forceinline__ float4 route(const float4& d, const float4& o,
                                        const float4& s) {
  return make_float4(route(d.x, o.x, s.x), route(d.y, o.y, s.y),
                     route(d.z, o.z, s.z), route(d.w, o.w, s.w));
}

// The (row, chunk) a warp owns and the column vector its lane handles.
struct Task {
  int beg, end;   // the row's entries
  int grp, p;     // this lane's edge group, the number of groups
  long long o;    // the output position (row * fv + f)
  int f;          // column vector
  bool active;    // f < fv
};

__device__ __forceinline__ bool task(const int* __restrict__ indptr,
                                     int n_rows, int fv, int chunks,
                                     int log_g, Task& t) {
  const long long w =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= (long long)n_rows * chunks) return false;   // warp-uniform
  const int row = (int)(w / chunks), chunk = (int)(w % chunks);
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;
  t.p = 32 >> log_g;
  t.grp = lane >> log_g;
  t.f = chunk * g + (lane & (g - 1));
  t.active = t.f < fv;
  t.o = (long long)row * fv + t.f;
  t.beg = indptr[row];
  t.end = indptr[row + 1];
  return true;
}

// K14. out[r, f] = max (kMin: min) over the row's entries of data[e, f].
template <typename V, bool kMin>
__global__ void __launch_bounds__(kThreads)
segment_extreme_kernel(const int* __restrict__ indptr,
                       const V* __restrict__ data, V* __restrict__ out,
                       int n_rows, int fv, int chunks, int log_g) {
  Task t;
  if (!task(indptr, n_rows, fv, chunks, log_g, t)) return;
  V acc = vfill<V>(kMin ? CUDART_INF_F : -CUDART_INF_F);
  if (t.active) {
#pragma unroll 4
    for (int e = t.beg + t.grp; e < t.end; e += t.p)
      acc = pick<kMin>(acc, data[(long long)e * fv + t.f]);
  }
  // the groups' lanes of one column are 1 << log_g apart
  for (int off = 32 / t.p; off < 32; off <<= 1)
    acc = pick<kMin>(acc, shfl(acc, off));
  if (t.active && t.grp == 0) out[t.o] = acc;
}

// K14's backward: count the entries of each (row, column) that equal the
// output, then route dy / count to each of them and 0 to the others.
template <typename V>
__global__ void __launch_bounds__(kThreads)
segment_extreme_bwd_kernel(const int* __restrict__ indptr,
                           const V* __restrict__ data,
                           const V* __restrict__ out,
                           const V* __restrict__ dy, V* __restrict__ ddata,
                           int n_rows, int fv, int chunks, int log_g) {
  Task t;
  if (!task(indptr, n_rows, fv, chunks, log_g, t)) return;
  const V o = t.active ? out[t.o] : vfill<V>(0.f);
  V cnt = vfill<V>(0.f);
  if (t.active) {
#pragma unroll 4
    for (int e = t.beg + t.grp; e < t.end; e += t.p)
      cnt = add(cnt, hit(data[(long long)e * fv + t.f], o));
  }
  for (int off = 32 / t.p; off < 32; off <<= 1)   // exact: small integers
    cnt = add(cnt, shfl(cnt, off));
  if (!t.active) return;
  const V s = share(dy[t.o], cnt);
#pragma unroll 4
  for (int e = t.beg + t.grp; e < t.end; e += t.p) {
    const long long i = (long long)e * fv + t.f;
    ddata[i] = route(data[i], o, s);
  }
}

int log_group(int fv) {
  int lg = 0;
  while ((1 << lg) < fv && lg < 5) ++lg;
  return lg;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Grid of one warp per (row, chunk of 32 vectors).
struct Shape {
  int fv, chunks, log_g;
  unsigned blocks;
};

Shape shape(int n_rows, int fv) {
  Shape s;
  s.fv = fv;
  s.log_g = log_group(fv);
  s.chunks = (fv + 31) / 32;
  const long long warps = (long long)n_rows * s.chunks;
  s.blocks = (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  return s;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). The caller
// allocates out [n_rows, f] and makes sure n_rows > 0, f > 0, that indptr's
// last entry is data's row count, and that the grid of n_rows times a row's
// chunks of 32 column vectors (float4 or scalar) has fewer than 2^34 warps.
int segment_max_csr_f32(const int* indptr, const float* data, float* out,
                        int n_rows, int f, int op_min, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f % 4 == 0 && aligned16(data) && aligned16(out)) {
    const Shape s = shape(n_rows, f / 4);
    const float4* d4 = reinterpret_cast<const float4*>(data);
    float4* o4 = reinterpret_cast<float4*>(out);
    if (op_min)
      segment_extreme_kernel<float4, true><<<s.blocks, kThreads, 0, st>>>(
          indptr, d4, o4, n_rows, s.fv, s.chunks, s.log_g);
    else
      segment_extreme_kernel<float4, false><<<s.blocks, kThreads, 0, st>>>(
          indptr, d4, o4, n_rows, s.fv, s.chunks, s.log_g);
  } else {
    const Shape s = shape(n_rows, f);
    if (op_min)
      segment_extreme_kernel<float, true><<<s.blocks, kThreads, 0, st>>>(
          indptr, data, out, n_rows, s.fv, s.chunks, s.log_g);
    else
      segment_extreme_kernel<float, false><<<s.blocks, kThreads, 0, st>>>(
          indptr, data, out, n_rows, s.fv, s.chunks, s.log_g);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same contract; ddata [rows, f] gets every entry of the CSR. Max and
// min share it: it routes dy to the entries that equal out.
int segment_max_bwd_csr_f32(const int* indptr, const float* data,
                            const float* out, const float* dy, float* ddata,
                            int n_rows, int f, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f % 4 == 0 && aligned16(data) && aligned16(out) && aligned16(dy) &&
      aligned16(ddata)) {
    const Shape s = shape(n_rows, f / 4);
    segment_extreme_bwd_kernel<float4><<<s.blocks, kThreads, 0, st>>>(
        indptr, reinterpret_cast<const float4*>(data),
        reinterpret_cast<const float4*>(out),
        reinterpret_cast<const float4*>(dy), reinterpret_cast<float4*>(ddata),
        n_rows, s.fv, s.chunks, s.log_g);
  } else {
    const Shape s = shape(n_rows, f);
    segment_extreme_bwd_kernel<float><<<s.blocks, kThreads, 0, st>>>(
        indptr, data, out, dy, ddata, n_rows, s.fv, s.chunks, s.log_g);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
