// Per-row max or min over a CSR (segment max): K14 and its backward, float32
// and bfloat16 (vec.cuh), for sm_90a.
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
// Layout of the work. A row's columns go to lanes as float4 when the caller
// asks for it (F % 4 == 0, pointers 16-byte aligned), else as scalars; G
// lanes (the vector count rounded up to a power of two, at most 32) cover a
// row's width, or a chunk of 32 vectors of a wider row. A warp takes R = 2^
// log_rows consecutive rows (R = 1 for chunked rows): each row owns 32 / R
// lanes, which split into P = 32 / (R G) edge groups that take interleaved
// entries, four independent loads in flight per lane to the row's end (the
// loads past it masked to the identity); the groups of one row meet by
// shuffles that never cross into another row's lanes. Each output is
// written by one lane, each entry of ddata by one lane, with no atomics.
// Max and min are one loop with the comparison reversed, not -max(-x),
// which would cost two more passes over [rows, F]. The caller (ops/cuda/
// segment.py:_rows_per_warp) picks R from the width and the mean row length
// so that each edge group walks at least 4 entries in the forward, 2 in the
// backward (which reads each entry twice). R = 1 at F = 4 left a warp with
// ~15 entries of one float4 for 32 groups, half its lanes idle, and 16
// waves of warps that each waited on indptr, then data, then 5 shuffles.
//
// Bound on an H100: memory. The forward reads each entry once (4 bytes
// against one comparison) and writes each output once; the rows are
// contiguous, so the no-L2-reuse traffic is the compulsory traffic. The
// backward counts the ties of a row in a first sweep and writes ddata in a
// second; the second sweep re-reads the row's entries, which the first just
// brought into L1/L2 (a row of 15 entries at F = 128 is 7.5 KB).
//
// Measured (chip_smoke.py --sweep, H100 at 700 W, N = 131,072, E = 2M; the
// profiler's device time): at F = 4, 0.053 ms at R = 1 against 0.011-0.014
// at R = 4-32; at F = 8, 0.051 at R = 1, 0.028-0.029 at R = 4-8; the
// backward 0.067 / 0.074 ms at R = 1, 0.031 / 0.053 at R = 8 / 4. Wide rows
// (F = 128) and the 3k batch's graph CSR (F = 64, ~19 entries) keep R = 1.
// Masking the last loads, where a scalar tail loop waited on one load after
// another, took 8-13 % off the forward at F = 4 and 8 and 7-8 % off the
// backward. Not built: a warp that reads its rows' contiguous span coalesced
// and reduces it by a segmented scan over lanes.
//
// bfloat16 (segment_max_csr_bf16, segment_max_bwd_csr_bf16): the columns
// load as bf16x8, bf16x4 or bf16x1 (vec.cuh) and are widened to float,
// which holds every bfloat16 exactly, so the max, the min and the tie test
// are the float32 ones and the stored extreme is exact. The backward
// divides dy by the count in float32 and rounds the share once to
// bfloat16: the bits of a bfloat16 division dy / count (the plain
// version's). The count stops at 256, as a sum of ones in bfloat16 does
// (ops.segment.count_as; JAX's segment max gradient counts so): past 256
// ties each gets dy / 256, as on the CPU and in JAX. V below is the storage
// vector, A = Acc<V> the float vector it is compared and divided in; for
// float32 both are float4 or float.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "vec.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

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
template <bool kMin>
__device__ __forceinline__ f8 pick(const f8& a, const f8& b) {
  return {pick<kMin>(a.lo, b.lo), pick<kMin>(a.hi, b.hi)};
}

__device__ __forceinline__ float shfl(float v, int off) {
  return __shfl_xor_sync(kFull, v, off);
}
__device__ __forceinline__ float4 shfl(const float4& v, int off) {
  return make_float4(shfl(v.x, off), shfl(v.y, off), shfl(v.z, off),
                     shfl(v.w, off));
}
__device__ __forceinline__ f8 shfl(const f8& v, int off) {
  return {shfl(v.lo, off), shfl(v.hi, off)};
}

// 1 where the entry equals the row's extreme, else 0
__device__ __forceinline__ float hit(float d, float o) {
  return d == o ? 1.f : 0.f;
}
__device__ __forceinline__ float4 hit(const float4& d, const float4& o) {
  return make_float4(hit(d.x, o.x), hit(d.y, o.y), hit(d.z, o.z),
                     hit(d.w, o.w));
}
__device__ __forceinline__ f8 hit(const f8& d, const f8& o) {
  return {hit(d.lo, o.lo), hit(d.hi, o.hi)};
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ f8 add(const f8& a, const f8& b) {
  return {add(a.lo, b.lo), add(a.hi, b.hi)};
}

// the count at most c (bfloat16's stop: see above)
__device__ __forceinline__ float cap(float cnt, float c) {
  return fminf(cnt, c);
}
__device__ __forceinline__ float4 cap(const float4& cnt, float c) {
  return make_float4(cap(cnt.x, c), cap(cnt.y, c), cap(cnt.z, c),
                     cap(cnt.w, c));
}
__device__ __forceinline__ f8 cap(const f8& cnt, float c) {
  return {cap(cnt.lo, c), cap(cnt.hi, c)};
}

// dy / count, 0 where no entry ties (a NaN output)
__device__ __forceinline__ float share(float dy, float cnt) {
  return cnt > 0.f ? dy / cnt : 0.f;
}
__device__ __forceinline__ float4 share(const float4& dy, const float4& cnt) {
  return make_float4(share(dy.x, cnt.x), share(dy.y, cnt.y),
                     share(dy.z, cnt.z), share(dy.w, cnt.w));
}
__device__ __forceinline__ f8 share(const f8& dy, const f8& cnt) {
  return {share(dy.lo, cnt.lo), share(dy.hi, cnt.hi)};
}

__device__ __forceinline__ float route(float d, float o, float s) {
  return d == o ? s : 0.f;
}
__device__ __forceinline__ float4 route(const float4& d, const float4& o,
                                        const float4& s) {
  return make_float4(route(d.x, o.x, s.x), route(d.y, o.y, s.y),
                     route(d.z, o.z, s.z), route(d.w, o.w, s.w));
}
__device__ __forceinline__ f8 route(const f8& d, const f8& o, const f8& s) {
  return {route(d.lo, o.lo, s.lo), route(d.hi, o.hi, s.hi)};
}

// The (row, chunk) a lane works on and the column vector it handles.
struct Task {
  int beg, end;   // the row's entries (none for a row past the last)
  int grp, p;     // this lane's edge group, the row's number of groups
  int seg;        // lanes per row: the row's groups meet within them
  int g;          // lanes per column vector group (G)
  long long o;    // the output position (row * fv + f)
  int f;          // column vector
  bool active;    // the row exists and f < fv
};

// Warp w takes rows [w / chunks * R, ... + R) and chunk w % chunks; lane l
// the row (l >> (5 - log_rows)). False (warp-uniform) past the last warp.
__device__ __forceinline__ bool task(const int* __restrict__ indptr,
                                     int n_rows, int fv, int chunks,
                                     int log_g, int log_rows, Task& t) {
  const long long w =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long blocks_of_rows =
      ((long long)n_rows + (1 << log_rows) - 1) >> log_rows;
  if (w >= blocks_of_rows * chunks) return false;
  const int chunk = (int)(w % chunks);
  const int lane = threadIdx.x & 31;
  const int log_seg = 5 - log_rows;
  const long long row = ((w / chunks) << log_rows) + (lane >> log_seg);
  const int sl = lane & ((1 << log_seg) - 1);   // lane within the row
  t.g = 1 << log_g;
  t.seg = 1 << log_seg;
  t.p = t.seg >> log_g;
  t.grp = sl >> log_g;
  t.f = chunk * t.g + (sl & (t.g - 1));
  const bool live = row < n_rows;
  t.active = live && t.f < fv;
  t.o = row * fv + t.f;
  t.beg = live ? indptr[row] : 0;
  t.end = live ? indptr[row + 1] : 0;
  return true;
}

// K14. out[r, f] = max (kMin: min) over the row's entries of data[e, f].
template <typename V, bool kMin>
__global__ void __launch_bounds__(kThreads)
segment_extreme_kernel(const int* __restrict__ indptr,
                       const V* __restrict__ data, V* __restrict__ out,
                       int n_rows, int fv, int chunks, int log_g,
                       int log_rows) {
  using A = Acc<V>;
  Task t;
  if (!task(indptr, n_rows, fv, chunks, log_g, log_rows, t)) return;
  const A none = vfill<A>(kMin ? CUDART_INF_F : -CUDART_INF_F);
  A acc = none;
  if (t.active) {
    const V* col = data + t.f;
    const int s = t.p;
    // four loads issued before any comparison, those past the row's end
    // masked to the identity (pick(acc, none) is acc, bit for bit), so the
    // tail of a short row does not wait on one load after another; entries
    // in order
    for (int e = t.beg + t.grp; e < t.end; e += 4 * s) {
      A a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        a[u] = e + u * s < t.end ? widen(col[(long long)(e + u * s) * fv])
                                 : none;
#pragma unroll
      for (int u = 0; u < 4; ++u) acc = pick<kMin>(acc, a[u]);
    }
  }
  // the groups' lanes of one column are G apart, within the row's lanes
  for (int off = t.g; off < t.seg; off <<= 1)
    acc = pick<kMin>(acc, shfl(acc, off));
  if (t.active && t.grp == 0) out[t.o] = narrow<V>(acc);
}

// K14's backward: count the entries of each (row, column) that equal the
// output, then route dy / count to each of them and 0 to the others.
template <typename V>
__global__ void __launch_bounds__(kThreads)
segment_extreme_bwd_kernel(const int* __restrict__ indptr,
                           const V* __restrict__ data,
                           const V* __restrict__ out,
                           const V* __restrict__ dy, V* __restrict__ ddata,
                           int n_rows, int fv, int chunks, int log_g,
                           int log_rows) {
  using A = Acc<V>;
  Task t;
  if (!task(indptr, n_rows, fv, chunks, log_g, log_rows, t)) return;
  const A zero = vfill<A>(0.f);
  const A o = t.active ? widen(out[t.o]) : zero;
  A cnt = zero;
  if (t.active) {   // four loads in flight, as in the forward
    for (int e = t.beg + t.grp; e < t.end; e += 4 * t.p) {
      A h[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = e + u * t.p;
        h[u] = k < t.end ? hit(widen(data[(long long)k * fv + t.f]), o)
                         : zero;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) cnt = add(cnt, h[u]);
    }
  }
  for (int off = t.g; off < t.seg; off <<= 1)   // exact: small integers
    cnt = add(cnt, shfl(cnt, off));
  if (!t.active) return;
  if constexpr (std::is_same<Scalar<V>, bf16x1>::value) cnt = cap(cnt, 256.f);
  const A s = share(widen(dy[t.o]), cnt);
  for (int e = t.beg + t.grp; e < t.end; e += 4 * t.p) {
    V d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = e + u * t.p;
      d[u] = k < t.end ? data[(long long)k * fv + t.f] : vzero<V>();
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = e + u * t.p;
      if (k < t.end)
        ddata[(long long)k * fv + t.f] = narrow<V>(route(widen(d[u]), o, s));
    }
  }
}

int log_group(int fv) {
  int lg = 0;
  while ((1 << lg) < fv && lg < 5) ++lg;
  return lg;
}

// Grid of one warp per (R rows, chunk of 32 vectors); 0 blocks when the
// caller's rows per warp does not fit the width.
struct Shape {
  int fv, chunks, log_g;
  unsigned blocks;
};

Shape shape(int n_rows, int fv, int log_rows) {
  Shape s;
  s.fv = fv;
  s.log_g = log_group(fv);
  s.chunks = (fv + 31) / 32;
  s.blocks = 0;
  if (log_rows < 0 || s.log_g + log_rows > 5) return s;
  const long long warps =
      (((long long)n_rows + (1 << log_rows) - 1) >> log_rows) * s.chunks;
  s.blocks = (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  return s;
}

template <typename V, bool kMin>
int launch_fwd(const int* indptr, const void* data, void* out, int n_rows,
               int fv, int log_rows, cudaStream_t st) {
  const Shape s = shape(n_rows, fv, log_rows);
  if (s.blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  segment_extreme_kernel<V, kMin><<<s.blocks, kThreads, 0, st>>>(
      indptr, static_cast<const V*>(data), static_cast<V*>(out), n_rows,
      s.fv, s.chunks, s.log_g, log_rows);
  return static_cast<int>(cudaGetLastError());
}

// K14, max or min, on rows of fv storage vectors V.
template <typename V>
int launch_extreme(const int* indptr, const void* data, void* out,
                   int n_rows, int fv, int op_min, int log_rows,
                   cudaStream_t st) {
  return op_min
      ? launch_fwd<V, true>(indptr, data, out, n_rows, fv, log_rows, st)
      : launch_fwd<V, false>(indptr, data, out, n_rows, fv, log_rows, st);
}

// K14's backward on rows of fv storage vectors V.
template <typename V>
int launch_bwd(const int* indptr, const void* data, const void* out,
               const void* dy, void* ddata, int n_rows, int fv,
               int log_rows, cudaStream_t st) {
  const Shape s = shape(n_rows, fv, log_rows);
  if (s.blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  segment_extreme_bwd_kernel<V><<<s.blocks, kThreads, 0, st>>>(
      indptr, static_cast<const V*>(data), static_cast<const V*>(out),
      static_cast<const V*>(dy), static_cast<V*>(ddata), n_rows, s.fv,
      s.chunks, s.log_g, log_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without launching when vec_bytes is not one
// f32_vec_ok allows (16: float4, f % 4 == 0, the pointers 16-byte aligned;
// 4: one float), or when log_rows is negative or R rows of the width do not
// fit in a warp (log2 G + log_rows > 5). The caller allocates out
// [n_rows, f] and makes sure n_rows > 0, f > 0, that indptr's last entry is
// data's row count, and that the grid has fewer than 2^34 warps. vec_bytes:
// the vector the columns load in; log_rows: log2 of the rows per warp.
int segment_max_csr_f32(const int* indptr, const float* data, float* out,
                        int n_rows, int f, int op_min, int vec_bytes,
                        int log_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!f32_vec_ok(f, vec_bytes, {data, out}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec_bytes == 16)
    return launch_extreme<float4>(indptr, data, out, n_rows, f / 4, op_min,
                                  log_rows, st);
  return launch_extreme<float>(indptr, data, out, n_rows, f, op_min,
                               log_rows, st);
}

// The same contract; ddata [rows, f] gets every entry of the CSR. Max and
// min share it: it routes dy to the entries that equal out.
int segment_max_bwd_csr_f32(const int* indptr, const float* data,
                            const float* out, const float* dy, float* ddata,
                            int n_rows, int f, int vec_bytes, int log_rows,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!f32_vec_ok(f, vec_bytes, {data, out, dy, ddata}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec_bytes == 16)
    return launch_bwd<float4>(indptr, data, out, dy, ddata, n_rows, f / 4,
                              log_rows, st);
  return launch_bwd<float>(indptr, data, out, dy, ddata, n_rows, f,
                           log_rows, st);
}

// K14 and its backward on bfloat16 columns, as segment_max_csr_f32 and
// segment_max_bwd_csr_f32, with vec_bytes the vector a
// row's columns load in (16: 8 values, f % 8 == 0, the pointers 16-byte
// aligned; 8: 4 values, 8-byte aligned; 2: one). Anything else returns
// cudaErrorInvalidValue with nothing launched.
int segment_max_csr_bf16(const int* indptr, const bf16x1* data, bf16x1* out,
                         int n_rows, int f, int op_min, int vec_bytes,
                         int log_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16_vec_ok(f, vec_bytes, {data, out}))
    return static_cast<int>(cudaErrorInvalidValue);
  const int fv = f / (vec_bytes / 2);
  if (vec_bytes == 16)
    return launch_extreme<bf16x8>(indptr, data, out, n_rows, fv, op_min,
                                  log_rows, st);
  if (vec_bytes == 8)
    return launch_extreme<bf16x4>(indptr, data, out, n_rows, fv, op_min,
                                  log_rows, st);
  return launch_extreme<bf16x1>(indptr, data, out, n_rows, fv, op_min,
                                log_rows, st);
}

int segment_max_bwd_csr_bf16(const int* indptr, const bf16x1* data,
                             const bf16x1* out, const bf16x1* dy,
                             bf16x1* ddata, int n_rows, int f, int vec_bytes,
                             int log_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16_vec_ok(f, vec_bytes, {data, out, dy, ddata}))
    return static_cast<int>(cudaErrorInvalidValue);
  const int fv = f / (vec_bytes / 2);
  if (vec_bytes == 16)
    return launch_bwd<bf16x8>(indptr, data, out, dy, ddata, n_rows, fv,
                              log_rows, st);
  if (vec_bytes == 8)
    return launch_bwd<bf16x4>(indptr, data, out, dy, ddata, n_rows, fv,
                              log_rows, st);
  return launch_bwd<bf16x1>(indptr, data, out, dy, ddata, n_rows, fv,
                            log_rows, st);
}

const char* gnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
