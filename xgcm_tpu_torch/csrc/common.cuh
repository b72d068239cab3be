// Shared helpers of the xgcm_tpu_torch kernels: dtype codes (kept equal to
// DTYPE_CODES in ops/kernels/build.py), loads that widen 16-bit types to
// float, stores that round once, the 2-point ops of the shift stencils
// (kernels A and E), the variable set of the multi-variable kernels, and
// the staging of column tiles in shared memory by cp.async (kernels C/F and
// G/H).
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

// Staging of column tiles in shared memory (kernels C/F and G/H).

// A 4-byte copy from device memory into shared memory that does not wait:
// the block waits for all of its copies at once (wait_copies).
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// The same for 16 bytes (both addresses 16-byte aligned).
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A (tc, nk) tile, element (c, k) at src[c * cs + k * ks], into
// dst[c * ds + k] as float.  Consecutive threads take consecutive elements
// along the smaller stride; the (outer, inner) position steps by the block
// size without a division per element.  float32 goes by copy_async, so every
// element of every tile of the block is in flight at once; 16-bit values are
// loaded eight at a time per thread, then widened and stored.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, long long cs, long long ks,
                                          int tc, int nk, float* dst, int ds) {
  constexpr bool kAsync = sizeof(T) == sizeof(float);
  constexpr int kBatch = kAsync ? 1 : 8;
  if (tc <= 0 || nk <= 0) return;
  if constexpr (kAsync) {
    // a contiguous tile into an unpadded one: 16-byte copies
    if (ks == 1 && cs == nk && ds == nk &&
        ((reinterpret_cast<unsigned long long>(src) | reinterpret_cast<unsigned long long>(dst)) &
         15) == 0) {
      const float* from = reinterpret_cast<const float*>(src);
      const int total = tc * nk, vec = total / 4;
      for (int i = threadIdx.x; i < vec; i += blockDim.x) copy_async16(dst + 4 * i, from + 4 * i);
      for (int i = 4 * vec + threadIdx.x; i < total; i += blockDim.x) copy_async(dst + i, from + i);
      return;
    }
  }
  const bool knots_fast = llabs(ks) <= llabs(cs);
  const int inner = knots_fast ? nk : tc;
  const long long s_in = knots_fast ? ks : cs, s_out = knots_fast ? cs : ks;
  const int d_in = knots_fast ? 1 : ds, d_out = knots_fast ? ds : 1;
  const int step_o = blockDim.x / inner, step_i = blockDim.x - step_o * inner;
  int o = threadIdx.x / inner, i = threadIdx.x - o * inner;
  for (int e = threadIdx.x; e < tc * nk; e += kBatch * blockDim.x) {
    T val[kBatch];
    int at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      at[u] = -1;
      if (e + u * (int)blockDim.x < tc * nk) {
        const T* from = src + (o * s_out + i * s_in);
        at[u] = o * d_out + i * d_in;
        if constexpr (kAsync) {
          copy_async(dst + at[u], reinterpret_cast<const float*>(from));
        } else {
          val[u] = *from;
        }
      }
      o += step_o;
      i += step_i;
      if (i >= inner) {
        i -= inner;
        ++o;
      }
    }
    if constexpr (!kAsync) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (at[u] >= 0) dst[at[u]] = xt::to_compute(val[u]);
      }
    }
  }
}

inline unsigned int blocks_for(long long work, int threads) {
  long long b = (work + threads - 1) / threads;
  return (unsigned int)(b < 1 ? 1 : b);
}

}  // namespace xt
