// Per-edge dot of endpoint features (SDDMM): K13, float32, for sm_90a.
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
// Layout of the work: one warp owns one (row, head) pair, all heads in one
// launch. A head's D floats split into vectors (float4 when D % 4 == 0 and
// xi, xj are 16-byte aligned) and the warp into edge groups of G lanes (G =
// the vector count rounded up to a power of two, at most 32) that take
// interleaved edges; each group reduces its edge's dot with shuffles. Rows
// wider than 32 vectors loop over chunks: the receiver's chunk stays in a
// register, and chunks after the first add to out[e], which the same lane
// owns in every chunk. Every output is written by one lane in a fixed order:
// no atomics, the same bits in every run.
//
// Bound on an H100: memory. Each edge gathers one xj row of H*D floats (512
// bytes at H=1, D=128) against 2*H*D flops; the receiver's row is read once
// per chunk and stays in a register. The compulsory traffic (each input and
// output once) is smaller than the gathered traffic, and the L2's reuse of
// gathered rows decides where between the two the kernel lands. Reducing
// each edge on its own costs log2 G shuffles per edge; two variants that
// batch 8 or 32 edges per lane and reduce them together (B - 1 shuffles for
// B edges) ran no faster at D = 128 (the 32-edge one 3.4x slower, at 246
// registers): the gathered rows, not the shuffles, set the time.

#include <cuda_runtime.h>
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

__device__ __forceinline__ float vdot(float a, float b) { return a * b; }
__device__ __forceinline__ float vdot(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// K13. Over the receiver CSR, row r, head h: out[e, h] = <xi[r, h], xj[col[e],
// h]> for each position e of the row.
template <typename V>
__global__ void __launch_bounds__(kThreads)
sddmm_csr_kernel(const int* __restrict__ indptr, const int* __restrict__ col,
                 const V* __restrict__ xi, const V* __restrict__ xj,
                 float* __restrict__ out, int n_rows, int heads, int dv,
                 int log_g) {
  const long long w =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= (long long)n_rows * heads) return;   // warp-uniform
  const int row = (int)(w / heads), h = (int)(w % heads);
  const int lane = threadIdx.x & 31;
  const int g = 1 << log_g;    // lanes per edge group
  const int p = 32 >> log_g;   // edge groups per warp
  const int grp = lane >> log_g;
  const int sub = lane & (g - 1);
  const int beg = indptr[row], end = indptr[row + 1];
  for (int c0 = 0; c0 < dv; c0 += g) {
    const int f = c0 + sub;
    const bool active = f < dv;
    const V xr = active ? xi[w * dv + f] : vzero<V>();
    for (int base = beg; base < end; base += p) {   // warp-uniform trips
      const int e = base + grp;
      const bool ok = e < end;
      float part = 0.f;
      if (ok && active)
        part = vdot(xr, xj[((long long)col[e] * heads + h) * dv + f]);
      for (int off = 1; off < g; off <<= 1)
        part += __shfl_xor_sync(kFull, part, off);
      if (ok && sub == 0) {
        float* o = out + (long long)e * heads + h;
        *o = c0 == 0 ? part : *o + part;
      }
    }
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

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success). The caller
// allocates out [E, heads] and makes sure n_rows > 0, heads > 0, d > 0 and
// n_rows * heads < 2^34 (one warp per pair in one grid).
int sddmm_csr_f32(const int* indptr, const int* col, const float* xi,
                  const float* xj, float* out, int n_rows, int heads, int d,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long warps = (long long)n_rows * heads;
  const unsigned nb =
      (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (d % 4 == 0 && aligned16(xi) && aligned16(xj)) {
    const int dv = d / 4;
    sddmm_csr_kernel<float4><<<nb, kThreads, 0, st>>>(
        indptr, col, reinterpret_cast<const float4*>(xi),
        reinterpret_cast<const float4*>(xj), out, n_rows, heads, dv,
        log_group(dv));
  } else {
    sddmm_csr_kernel<float><<<nb, kThreads, 0, st>>>(
        indptr, col, xi, xj, out, n_rows, heads, d, log_group(d));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
