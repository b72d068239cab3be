// Shared helpers of the xgcm_tpu_torch kernels: dtype codes (kept equal to
// DTYPE_CODES in ops/kernels/build.py), loads that widen 16-bit types to
// float, stores that round once, the 2-point ops of the shift stencils
// (kernels A and E), and the variable set of the multi-variable kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace xt {

enum Dtype : int { F32 = 0, F64 = 1, F16 = 2, BF16 = 3 };

// Compute type: 16-bit and 32-bit floats are computed in float, double in
// double.
template <typename T> struct Compute { using type = float; };
template <> struct Compute<double> { using type = double; };

__device__ __forceinline__ float to_compute(float x) { return x; }
__device__ __forceinline__ double to_compute(double x) { return x; }
__device__ __forceinline__ float to_compute(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_compute(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_compute(float x);
template <> __device__ __forceinline__ float from_compute<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_compute<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_compute<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ __forceinline__ T from_compute(double x);
template <> __device__ __forceinline__ double from_compute<double>(double x) { return x; }

// A double rounded to T and widened to T's compute type (a fill value
// takes the array's dtype first, as jnp.asarray(fill_value, x.dtype) does).
template <typename T> __device__ __forceinline__ typename Compute<T>::type round_to(double x);
template <> __device__ __forceinline__ float round_to<float>(double x) { return (float)x; }
template <> __device__ __forceinline__ double round_to<double>(double x) { return x; }
template <> __device__ __forceinline__ float round_to<__half>(double x) {
  return __half2float(__double2half(x));
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(double x) {
  return __bfloat162float(__double2bfloat16(x));
}

// The 2-point ops of the shift stencils, on (lower-index, higher-index)
// operands, as ops/stencils.py PAIR_OPS (codes kept equal to _OPS in
// ops/kernels/shift.py).
enum Op : int { DIFF = 0, INTERP = 1, MIN = 2, MAX = 3 };

template <typename C>
__device__ __forceinline__ C pair_op(int op, C lo, C hi) {
  switch (op) {
    case DIFF:
      return hi - lo;
    case INTERP:
      return (hi + lo) * C(0.5);
    case MIN:  // NaN-propagating, operand order of torch.minimum(lo, hi)
      if (lo != lo) return lo;
      if (hi != hi) return hi;
      return (hi < lo) ? hi : lo;
    default:  // MAX
      if (lo != lo) return lo;
      if (hi != hi) return hi;
      return (lo < hi) ? hi : lo;
  }
}

// Up to kMaxVars variables that share one geometry (kernels C/F and G/H):
// each variable's input pointer and (column, level) strides, and its output,
// the outputs sharing one layout.  The fixed size of these arrays bounds V;
// callers route more variables to a loop of single calls.
constexpr int kMaxVars = 8;

template <typename T> struct VarSet {
  const T* in[kMaxVars];
  long long cs[kMaxVars];
  long long ks[kMaxVars];
  T* out[kMaxVars];
};

template <typename T>
VarSet<T> make_varset(int nv, const void* const* in, const long long* cs, const long long* ks,
                      void* const* out) {
  VarSet<T> s = {};
  for (int v = 0; v < nv && v < kMaxVars; ++v) {
    s.in[v] = static_cast<const T*>(in[v]);
    s.cs[v] = cs[v];
    s.ks[v] = ks[v];
    s.out[v] = static_cast<T*>(out[v]);
  }
  return s;
}

inline unsigned int blocks_for(long long work, int threads) {
  long long b = (work + threads - 1) / threads;
  return (unsigned int)(b < 1 ? 1 : b);
}

}  // namespace xt
