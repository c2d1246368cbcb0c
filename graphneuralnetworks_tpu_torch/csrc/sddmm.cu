// Per-edge dot of endpoint features (SDDMM): K13, float32 and bfloat16
// (vec.cuh), for sm_90a.
//
// Replaces graphneuralnetworks_tpu/ops/pallas/sddmm.py:_sddmm_kernel (receiver
// rows distributed to edge slots by a one-hot MXU matmul over 128x512 blocks,
// then a lane reduction, then an ungrouping gather back to edge order).
//
//   out[e, h] = <xi[r_e, h], xj[s_e, h]>      for every edge e and head h
//
// Layouts (row-major, contiguous): indptr int32[n_rows + 1] and col int32[E]
// (the senders) are the receiver CSR; xi [n_rows, H, D], xj [n_src, H, D];
// out [E, H]. Edges are stored sorted by receiver, so a position of the
// receiver CSR is the edge id and the kernel writes out[e] in edge order
// directly: nothing to ungroup.
//
// Bound on an H100: memory, and what decides it is the gathered table. Each
// edge gathers one xj row of H*D floats against 2*H*D flops: at N = 131,072,
// E = 2M and H*D = 128 that is ~1.1 GB through the L2 against 0.15 GB of
// compulsory traffic, with a 64 MB table under random senders that the
// 50 MB L2 holds only in part.
//
// Layout of the work:
// (a) One warp takes kPairs = 4 consecutive (row, head) pairs, one after
//     the other. A head's D floats split into vectors (float4 when the
//     caller asks: D % 4 == 0 and xi, xj 16-byte aligned) and the warp into
//     edge groups of G lanes (G = the vector count rounded up to a power of
//     two, at most 32). The warp loads its rows' indptr entries in one load
//     and 32 of a row's column indices in another, broadcasts each edge's
//     sender by a shuffle, and each group issues kUnroll = 4 gathers before
//     it reduces any of them by shuffles. The next pair's xi vector and
//     first indices are loaded before the current pair's gathers: the first
//     port's warp waited on indptr, then col, then each gathered row in turn.
//     The kernel is held to 64 registers (4 blocks of 8 warps per SM) with
//     no spills; left free, the look-ahead took 80 (3 blocks).
// (b) The gathered rows are loaded with an L2 evict_last policy and the
//     operands read once with evict-first loads (below).
// (c) Rows wider than 32 vectors run as one launch per chunk of 32 vectors
//     (128 floats with float4), in order on the stream; chunks after the
//     first add their partial dot to out[e], in the order the first port
//     added them, so the per-edge sum order is unchanged.
// Every output is written by one lane in a fixed order: no atomics, the
// same bits in every run.
//
// bfloat16 (sddmm_csr_bf16): the rows load as bf16x8, bf16x4 or bf16x1
// (vec.cuh), each product is taken on the values widened to float and the
// dot summed in float32 and rounded once to bfloat16, as the TPU kernel
// sums an f32 dot of each 128-512 lane block and rounds it to the rows'
// type. Rows wider than one chunk (256 values in bf16x8) keep the partial
// dots of the chunks before the last in a float32 [E, H] scratch, and the
// last chunk rounds the sum once.
//
// Tried and dropped (chip_smoke.py --sweep on an H100 at 700 W): cutting the
// senders into contiguous tiles that fit an L2 budget, the grid ordered tile
// by tile and each warp taking only its row's edges in its tile. Tiles of
// 12-32 MB (T = 2-6) were slower than one tile at every width, from 1 %
// (D = 128, T = 2) to 3.6x (H = 4, D = 32, T = 6): each tile re-reads xi and
// the indices (T * 72 MB at D = 128), and gathers that hit the L2 are held
// by its throughput. One pair per warp was 4-37 % slower than 4, and the L2
// priorities gain 1-3 %. Against the 64-register kernel, the look-ahead at
// 80 registers ran 14-24 % slower, and no look-ahead (48-64 registers) 2-8 %
// slower (D = 32 to 512).
//
// Measured (the profiler's device time, N = 131,072, E = 2M; PERF.md §6):
// 0.285 ms at D = 128 against 0.373 for the first port and 0.346 for
// torch.sparse.sampled_addmm; 1.22 ms at D = 512 (1.67, 1.48). That is
// 0.86x the bound with no L2 reuse at D = 128: ~3.8 TB/s of gathered rows
// through the L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kUnroll = 4;   // gathers a group issues before reducing
constexpr int kPairs = 4;    // (row, head) pairs per warp

// L2 eviction priorities (sm_80+): the gathered rows are loaded with an
// evict_last policy (createpolicy and the .L2::cache_hint load qualifier),
// what a warp reads once (its xi vectors, its column indices) with
// ld.global.cs (evict first), so that the streamed operands do not push
// gathered rows out of the L2.
__device__ __forceinline__ unsigned long long keep_policy() {
  unsigned long long p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ float ld_keep(const float* a,
                                         unsigned long long p) {
  float v;
  asm("ld.global.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v) : "l"(a), "l"(p));
  return v;
}
__device__ __forceinline__ float4 ld_keep(const float4* a,
                                          unsigned long long p) {
  float4 v;
  asm("ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(a), "l"(p));
  return v;
}
__device__ __forceinline__ bf16x8 ld_keep(const bf16x8* a,
                                          unsigned long long p) {
  bf16x8 v;
  asm("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(a), "l"(p));
  return v;
}
__device__ __forceinline__ bf16x4 ld_keep(const bf16x4* a,
                                          unsigned long long p) {
  bf16x4 v;
  asm("ld.global.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
      : "=r"(v.x), "=r"(v.y) : "l"(a), "l"(p));
  return v;
}
__device__ __forceinline__ bf16x1 ld_keep(const bf16x1* a,
                                          unsigned long long p) {
  bf16x1 v;
  asm("ld.global.L2::cache_hint.u16 %0, [%1], %2;"
      : "=h"(v) : "l"(a), "l"(p));
  return v;
}

// K13 over the receiver CSR for column vectors [c0, c0 + G) of each head:
// out[e, h] (+)= <xi[r, h], xj[col[e], h]> over that chunk, for each
// position e of row r. A warp takes kPairs consecutive (row, head) pairs,
// one after the other: the indptr entries of all their rows come in one
// load, and the next pair's xi vector and first 32 column indices are
// loaded before the current pair's gathers, so that only the gathers wait
// on memory. V is the rows' storage vector (vec.cuh). The float32 dots
// (the float32 out, or a bfloat16 row's chunks before the last) sum into
// acc [E, H]; with kRound (a bfloat16 row's last chunk) the share is added
// to acc's and stored to out[e, h] in the rows' type, rounded once.
template <typename V, bool kRound>
__global__ void __launch_bounds__(kThreads, 4)
sddmm_csr_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                 const V* __restrict__ xi, const V* __restrict__ xj,
                 float* __restrict__ acc, Scalar<V>* __restrict__ out,
                 int n_rows, int heads, int dv, int log_g, int c0) {
  const int lane = threadIdx.x & 31;
  const long long n_pairs = (long long)n_rows * heads;
  const long long q0 =
      ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * kPairs;
  if (q0 >= n_pairs) return;   // warp-uniform
  const long long q_end = q0 + kPairs < n_pairs ? q0 + kPairs : n_pairs;
  const int g = 1 << log_g;    // lanes per edge group
  const int p = 32 >> log_g;   // edge groups per warp
  const int grp = lane >> log_g;
  const int sub = lane & (g - 1);
  const int f = c0 + sub;
  const bool active = f < dv;
  const unsigned long long pol = keep_policy();
  // lane i holds indptr[r0 + i] for the warp's rows r0 .. r0 + nr - 1
  const int r0 = (int)(q0 / heads);
  const int nr = (int)((q_end - 1) / heads) - r0 + 1;   // <= kPairs
  const int ip = lane <= nr ? indptr[r0 + lane] : 0;
  // pair q's range, first 32 column indices and xi vector
  auto fetch = [&](long long q, int& beg, int& end, int& c, V& xr) {
    const int r = (int)(q / heads) - r0;
    beg = __shfl_sync(kFull, ip, r);
    end = __shfl_sync(kFull, ip, r + 1);
    c = beg + lane < end ? __ldcs(col + beg + lane) : 0;
    xr = active ? ld_cs(xi + q * dv + f) : vzero<V>();
  };
  int beg, end, c;
  V xr;
  fetch(q0, beg, end, c, xr);
  for (long long q = q0; q < q_end; ++q) {   // warp-uniform trips
    int nbeg = 0, nend = 0, nc = 0;
    V nxr = vzero<V>();
    if (q + 1 < q_end) fetch(q + 1, nbeg, nend, nc, nxr);
    const int h = (int)(q % heads);
    for (int base = beg; base < end; base += 32) {   // warp-uniform trips
      if (base != beg) c = base + lane < end ? __ldcs(col + base + lane) : 0;
      const int n = end - base < 32 ? end - base : 32;
      for (int k0 = 0; k0 < n; k0 += p * kUnroll) {   // warp-uniform trips
        V v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {   // edge k's sender from lane k
          const int k = k0 + u * p + grp;
          const int s = __shfl_sync(kFull, c, k & 31);
          v[u] = k < n && active
              ? ld_keep(xj + ((long long)s * heads + h) * dv + f, pol)
              : vzero<V>();
        }
        float part[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          part[u] = vdot(widen(xr), widen(v[u]));
        for (int off = 1; off < g; off <<= 1) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            part[u] += __shfl_xor_sync(kFull, part[u], off);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = k0 + u * p + grp;
          if (k < n && sub == 0) {
            const long long o = (long long)(base + k) * heads + h;
            if constexpr (kRound) {
              stf(out + o, c0 > 0 ? acc[o] + part[u] : part[u]);
            } else {
              float* a = acc + o;
              *a = c0 > 0 ? *a + part[u] : part[u];
            }
          }
        }
      }
    }
    beg = nbeg;
    end = nend;
    c = nc;
    xr = nxr;
  }
}

int log_group(int dv) {
  int lg = 0;
  while ((1 << lg) < dv && lg < 5) ++lg;
  return lg;
}

// One launch per chunk of 32 vectors of a head's row, in order, each
// summing into acc; out (bfloat16 rows only, else NULL) takes the last
// chunk's rounded sums.
template <typename V>
int launch(const int* indptr, const int* col, const void* xi,
           const void* xj, float* acc, Scalar<V>* out, int n_rows,
           int heads, int dv, cudaStream_t st) {
  const long long warps = ((long long)n_rows * heads + kPairs - 1) / kPairs;
  const unsigned blocks =
      (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int lg = log_group(dv);
  for (int c0 = 0; c0 < dv; c0 += 1 << lg) {
    const V* a = static_cast<const V*>(xi);
    const V* b = static_cast<const V*>(xj);
    if (out != nullptr && c0 + (1 << lg) >= dv)
      sddmm_csr_kernel<V, true><<<blocks, kThreads, 0, st>>>(
          indptr, col, a, b, acc, out, n_rows, heads, dv, lg, c0);
    else
      sddmm_csr_kernel<V, false><<<blocks, kThreads, 0, st>>>(
          indptr, col, a, b, acc, out, n_rows, heads, dv, lg, c0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue without launching when vec_bytes is not one
// f32_vec_ok allows (16: float4, d % 4 == 0, xi and xj 16-byte aligned; 4:
// one float). The caller allocates out [E, heads] and makes sure
// n_rows > 0, heads > 0, d > 0 and n_rows * heads < 2^35. vec_bytes: the
// vector a row loads in.
int sddmm_csr_f32(const int* indptr, const int* col, const float* xi,
                  const float* xj, float* out, int n_rows, int heads, int d,
                  int vec_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!f32_vec_ok(d, vec_bytes, {xi, xj}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec_bytes == 16)
    return launch<float4>(indptr, col, xi, xj, out, nullptr, n_rows, heads,
                          d / 4, st);
  return launch<float>(indptr, col, xi, xj, out, nullptr, n_rows, heads, d,
                       st);
}

// K13 on bfloat16 rows: out [E, heads] in bfloat16, each dot summed in
// float32 and rounded once. vec_bytes: the vector a row loads in (16: 8
// values, d % 8 == 0, xi and xj 16-byte aligned; 8: 4 values, 8-byte
// aligned; 2: one); anything else returns cudaErrorInvalidValue with
// nothing launched, as does a row of more than one chunk of 32 vectors
// without acc, a float32 [E, heads] scratch for the chunks' partial dots
// (NULL otherwise). The caller's checks as sddmm_csr_f32's.
int sddmm_csr_bf16(const int* indptr, const int* col, const bf16x1* xi,
                   const bf16x1* xj, bf16x1* out, float* acc, int n_rows,
                   int heads, int d, int vec_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16_vec_ok(d, vec_bytes, {xi, xj}))
    return static_cast<int>(cudaErrorInvalidValue);
  const int dv = d / (vec_bytes / 2);
  if (dv > 32 && acc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec_bytes == 16)
    return launch<bf16x8>(indptr, col, xi, xj, acc, out, n_rows, heads, dv,
                          st);
  if (vec_bytes == 8)
    return launch<bf16x4>(indptr, col, xi, xj, acc, out, n_rows, heads, dv,
                          st);
  return launch<bf16x1>(indptr, col, xi, xj, acc, out, n_rows, heads, dv,
                        st);
}

const char* gnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
