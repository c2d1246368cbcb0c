// Row vectors of the row-walking kernels (spmm.cu, edge_softmax.cu,
// sddmm.cu, segment.cu): the type a row is loaded and stored in, and the
// float type it is summed in.
//
// float32 rows load as float4 (16 bytes) or float and are summed in the
// same type. bfloat16 rows load as 8 values in 16 bytes (bf16x8, a uint4),
// 4 in 8 bytes (bf16x4, a uint2) or one (bf16x1, the 16 bits), are widened
// to float in registers (f8, float4, float), summed in float32, and
// rounded once to bfloat16 (round to nearest even, __float2bfloat16_rn)
// when stored. Per-node and per-edge scalars of a bfloat16 kernel (GAT's
// pi, pj, dpi, dpj; K1's and K2's edge weights, K2's dots; K12's logits
// and mask; K13's dots) are bf16x1 as well; the softmax state (m, s, mx,
// den, s_n) and K2's and K13's partial sums stay float32.
//
// Acc<V> names the sum type of storage type V, Scalar<V> the scalar type
// that goes with V's rows. widen() and narrow<V>() convert; for float32
// both are the identity, so the float32 kernels compile as before.
// vzero<T>() and vfill<T>(a) are a vector of zeros and of a, for the sum
// types and (vzero) the storage types. ld_cs and st_cs are __ldcs / __stcs
// (evict-first) for every storage type.

#ifndef GNN_CSRC_VEC_CUH_
#define GNN_CSRC_VEC_CUH_

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr unsigned kFull = 0xffffffffu;

using bf16x8 = uint4;
using bf16x4 = uint2;
using bf16x1 = unsigned short;

// eight floats: the sum type of a bf16x8
struct f8 {
  float4 lo, hi;
};

template <typename V> struct AccOf { using type = V; };
template <> struct AccOf<bf16x8> { using type = f8; };
template <> struct AccOf<bf16x4> { using type = float4; };
template <> struct AccOf<bf16x1> { using type = float; };
template <typename V> using Acc = typename AccOf<V>::type;

template <typename V> struct ScalarOf { using type = float; };
template <> struct ScalarOf<bf16x8> { using type = bf16x1; };
template <> struct ScalarOf<bf16x4> { using type = bf16x1; };
template <> struct ScalarOf<bf16x1> { using type = bf16x1; };
template <typename V> using Scalar = typename ScalarOf<V>::type;

template <typename V> __device__ __forceinline__ V vzero();
template <> __device__ __forceinline__ float vzero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <> __device__ __forceinline__ f8 vzero<f8>() {
  return {vzero<float4>(), vzero<float4>()};
}
template <> __device__ __forceinline__ bf16x8 vzero<bf16x8>() {
  return make_uint4(0u, 0u, 0u, 0u);
}
template <> __device__ __forceinline__ bf16x4 vzero<bf16x4>() {
  return make_uint2(0u, 0u);
}
template <> __device__ __forceinline__ bf16x1 vzero<bf16x1>() { return 0; }

template <typename T> __device__ __forceinline__ T vfill(float a);
template <> __device__ __forceinline__ float vfill<float>(float a) {
  return a;
}
template <> __device__ __forceinline__ float4 vfill<float4>(float a) {
  return make_float4(a, a, a, a);
}
template <> __device__ __forceinline__ f8 vfill<f8>(float a) {
  return {vfill<float4>(a), vfill<float4>(a)};
}

// ---- bfloat16 <-> float ------------------------------------------------------

// the bfloat16 in the low and the high half of a 32-bit word
__device__ __forceinline__ float bf_lo(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ unsigned bf_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}
__device__ __forceinline__ unsigned bf_pack(float lo, float hi) {
  return bf_bits(lo) | (bf_bits(hi) << 16);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float4 widen(const float4& v) { return v; }
__device__ __forceinline__ float widen(bf16x1 v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}
__device__ __forceinline__ float4 widen(const bf16x4& v) {
  return make_float4(bf_lo(v.x), bf_hi(v.x), bf_lo(v.y), bf_hi(v.y));
}
__device__ __forceinline__ f8 widen(const bf16x8& v) {
  return {make_float4(bf_lo(v.x), bf_hi(v.x), bf_lo(v.y), bf_hi(v.y)),
          make_float4(bf_lo(v.z), bf_hi(v.z), bf_lo(v.w), bf_hi(v.w))};
}

template <typename V> __device__ __forceinline__ V narrow(const Acc<V>& a);
template <> __device__ __forceinline__ float narrow<float>(const float& a) {
  return a;
}
template <> __device__ __forceinline__ float4 narrow<float4>(const float4& a) {
  return a;
}
template <> __device__ __forceinline__ bf16x1 narrow<bf16x1>(const float& a) {
  return static_cast<bf16x1>(bf_bits(a));
}
template <> __device__ __forceinline__ bf16x4 narrow<bf16x4>(const float4& a) {
  return make_uint2(bf_pack(a.x, a.y), bf_pack(a.z, a.w));
}
template <> __device__ __forceinline__ bf16x8 narrow<bf16x8>(const f8& a) {
  return make_uint4(bf_pack(a.lo.x, a.lo.y), bf_pack(a.lo.z, a.lo.w),
                    bf_pack(a.hi.x, a.hi.y), bf_pack(a.hi.z, a.hi.w));
}

// a scalar operand (a weight, pi, pj) as float, and a float as a scalar
// output (dpi, dpj) of type S
__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const bf16x1* p) { return widen(*p); }
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(bf16x1* p, float v) {
  *p = narrow<bf16x1>(v);
}

template <typename V> __device__ __forceinline__ V ld_cs(const V* p) {
  return __ldcs(p);
}
template <typename V> __device__ __forceinline__ void st_cs(V* p, V v) {
  __stcs(p, v);
}

// ---- arithmetic on the sum types ---------------------------------------------

__device__ __forceinline__ void axpy(float& a, float w, float v) {
  a = fmaf(w, v, a);
}
__device__ __forceinline__ void axpy(float4& a, float w, const float4& v) {
  a.x = fmaf(w, v.x, a.x);
  a.y = fmaf(w, v.y, a.y);
  a.z = fmaf(w, v.z, a.z);
  a.w = fmaf(w, v.w, a.w);
}
__device__ __forceinline__ void axpy(f8& a, float w, const f8& v) {
  axpy(a.lo, w, v.lo);
  axpy(a.hi, w, v.hi);
}

__device__ __forceinline__ float vdot(float a, float b) { return a * b; }
__device__ __forceinline__ float vdot(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float vdot(const f8& a, const f8& b) {
  return vdot(a.lo, b.lo) + vdot(a.hi, b.hi);
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
__device__ __forceinline__ void add_xor(f8& a, int off) {
  add_xor(a.lo, off);
  add_xor(a.hi, off);
}

__device__ __forceinline__ void vscale(float& a, float s) { a *= s; }
__device__ __forceinline__ void vscale(float4& a, float s) {
  a.x *= s;
  a.y *= s;
  a.z *= s;
  a.w *= s;
}
__device__ __forceinline__ void vscale(f8& a, float s) {
  vscale(a.lo, s);
  vscale(a.hi, s);
}

// ---- host side -------------------------------------------------------------

// Whether rows of d values of elem bytes at the pointers `rows` (NULL ones
// aside) load as vectors of vec_bytes: one value (vec_bytes == elem) needs
// nothing; 16 bytes (float4, bf16x8) or, for bfloat16, 8 (bf16x4) need d a
// multiple of the vector's values and rows aligned to its bytes. Every
// library entry point takes the vector's bytes and refuses any other.
inline bool vec_ok(int elem, int d, int vec_bytes,
                   std::initializer_list<const void*> rows) {
  if (vec_bytes == elem) return true;
  if ((vec_bytes != 16 && (vec_bytes != 8 || elem != 2)) ||
      d % (vec_bytes / elem) != 0)
    return false;
  for (const void* p : rows)
    if (p != nullptr &&
        (reinterpret_cast<uintptr_t>(p) & (vec_bytes - 1)) != 0)
      return false;
  return true;
}
// float32 rows: 16 (float4) or 4
inline bool f32_vec_ok(int d, int vec_bytes,
                       std::initializer_list<const void*> rows) {
  return vec_ok(4, d, vec_bytes, rows);
}
// bfloat16 rows: 16 (bf16x8), 8 (bf16x4) or 2 (bf16x1)
inline bool bf16_vec_ok(int d, int vec_bytes,
                        std::initializer_list<const void*> rows) {
  return vec_ok(2, d, vec_bytes, rows);
}

// The widest vector bfloat16 rows of d values at `rows` load in (see
// bf16_vec_ok): 16, 8 or 2 bytes. ops/cuda/spmm.py:_row_vectors picks the
// same for the layouts.
inline int bf16_vec_bytes(int d, std::initializer_list<const void*> rows) {
  return bf16_vec_ok(d, 16, rows) ? 16 : bf16_vec_ok(d, 8, rows) ? 8 : 2;
}

}  // namespace

#endif  // GNN_CSRC_VEC_CUH_
