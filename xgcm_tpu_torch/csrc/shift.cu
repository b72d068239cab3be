// Kernel A: the fused 1D shift stencil of the Grid fast path.
//
// Replaces: xgcm_tpu/ops/pallas_stencils.py, shift_op / _shift_kernel (and
// the semantics of its XLA twin xgcm_tpu/ops/fused.py, fused_shift_op,
// which the JAX Grid calls).
//
// out[i] = op(x[i-1], x[i]) ("left") or op(x[i], x[i+1]) ("right") along one
// axis of a contiguous array viewed as (outer, n, inner); op is diff,
// interp, min or max; the one wrapped edge line takes the boundary
// condition: periodic (the wrap itself), fill (a constant), extend (the edge
// value) or extrapolate (2 * edge - next inward).
//
// Bound on the card: memory.  One read of x and one write of out per
// element, no arithmetic to speak of.  Design: no division per element, and
// 16-byte accesses wherever the layout allows them.
//
// * inner == 1 (shift_rows): a row of n contiguous elements is cut into
//   vectors of VW = 16 / sizeof(T) elements, one per thread; the row comes
//   from the block's y coordinate, the vector from its x coordinate.  The one
//   element that crosses a vector comes from the neighbouring lane
//   (__shfl_up_sync / __shfl_down_sync, in segments of one row); the end
//   lanes of a segment read it from memory.  Only the row's first (left) or
//   last (right) element takes the boundary condition.
// * inner > 1 (shift_planes): threads walk along inner, one vector each,
//   and take one batch of S rows of the (n, inner) plane, loading its S + 1
//   input rows at once so that S + 1 loads are in flight; x is read
//   (S + 1) / S times, the extra row mostly from the L2.  The neighbour of
//   a vector is the whole aligned vector one row away.  Only the plane's
//   edge row takes the boundary condition.  S holds 16 values of the
//   compute type a thread (4 rows of float4; 8 rows on the scalar route).
//   Strips that a thread walked batch after batch, the last row kept in
//   registers, read x once but were slower on the card (PERF.md).
//
// The vector form needs 16-byte aligned x and out and a contiguous run (n,
// or inner) that is a multiple of VW; any other view (a misaligned data
// pointer, odd widths) runs the same kernels with VW = 1, one element a
// thread.  Offsets inside a row or plane are 32-bit, on a 64-bit base per
// row or plane; a row or plane of 2^31 - 2^13 elements or more takes the
// 64-bit instantiation.  16-bit types load into float and round once at the
// store; double computes in double.
#include "common.cuh"

namespace {

enum Bc : int { PERIODIC = 0, FILL = 1, EXTEND = 2, EXTRAPOLATE = 3 };

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
// rows or planes below this many elements take 32-bit offsets (the slack
// covers a block's overrun past the end and the neighbour row)
constexpr long long kIndex32 = (1LL << 31) - (1LL << 13);

template <typename T, int VW>
struct alignas(sizeof(T) * VW) Vec {
  T v[VW];
};

template <typename T, int VW, typename C>
__device__ __forceinline__ void load_vec(C (&dst)[VW], const T* p) {
  const Vec<T, VW> v = *reinterpret_cast<const Vec<T, VW>*>(p);
#pragma unroll
  for (int i = 0; i < VW; ++i) dst[i] = xt::to_compute(v.v[i]);
}

template <typename T, int VW, typename C>
__device__ __forceinline__ void store_vec(T* p, const C (&src)[VW]) {
  Vec<T, VW> v;
#pragma unroll
  for (int i = 0; i < VW; ++i) v.v[i] = xt::from_compute<T>(src[i]);
  *reinterpret_cast<Vec<T, VW>*>(p) = v;
}

// 2 * e - in, rounded after the product as the plain version rounds it (no
// FMA contraction, which would keep a product that overflows finite)
__device__ __forceinline__ float extrapolate(float e, float in) {
  return __fsub_rn(__fmul_rn(2.0f, e), in);
}
__device__ __forceinline__ double extrapolate(double e, double in) {
  return __dsub_rn(__dmul_rn(2.0, e), in);
}

// The neighbour of an edge element e under the boundary condition: wrap is
// the element at the far end (periodic), in the next element inward.
template <typename C>
__device__ __forceinline__ C edge_value(int bc, C e, C wrap, C in, C fill) {
  switch (bc) {
    case FILL: return fill;
    case EXTEND: return e;
    case EXTRAPOLATE: return extrapolate(e, in);
    default: return wrap;  // PERIODIC
  }
}

// inner == 1: rows of n contiguous elements, one vector of VW a thread.
// Block (tx, ty): tx threads along a row (a power of two), ty rows; the
// shuffles run in segments of min(tx, 32) lanes, each within one row.
template <typename T, int VW, typename I>
__global__ void __launch_bounds__(kThreads)
shift_rows(const T* __restrict__ x, T* __restrict__ out, long long outer, I n, int op, int left,
           int bc, double fill_value) {
  using C = typename xt::Compute<T>::type;
  const C fill = xt::round_to<T>(fill_value);
  const int width = blockDim.x < 32 ? (int)blockDim.x : 32;
  const int lane = threadIdx.x & (width - 1);
  const I chunk = (I)blockDim.x * VW;
  const I chunks = (n + chunk - 1) / chunk;
  for (long long rb = (long long)blockIdx.y * blockDim.y; rb < outer;
       rb += (long long)gridDim.y * blockDim.y) {
    const long long row = rb + threadIdx.y;
    const bool row_ok = row < outer;
    const T* xr = x + row * (long long)n;
    T* outr = out + row * (long long)n;
    for (I cb = (I)blockIdx.x; cb < chunks; cb += (I)gridDim.x) {
      const I p = cb * chunk + (I)threadIdx.x * VW;
      const bool ok = row_ok && p < n;
      C e[VW];
      if (ok) {
        load_vec<T, VW>(e, xr + p);
      } else {
#pragma unroll
        for (int i = 0; i < VW; ++i) e[i] = C(0);
      }
      // every lane of the warp takes part in the shuffles
      const C below = __shfl_up_sync(kFullMask, e[VW - 1], 1, width);
      const C above = __shfl_down_sync(kFullMask, e[0], 1, width);
      if (!ok) continue;
      C r[VW];
      if (left) {
        C nb;
        if (p == 0) {
          C in = e[0];
          if (n > 1) {
            if constexpr (VW > 1) in = e[1];
            else if (bc == EXTRAPOLATE) in = xt::to_compute(xr[1]);
          }
          const C wrap = bc == PERIODIC ? xt::to_compute(xr[n - 1]) : e[0];
          nb = edge_value(bc, e[0], wrap, in, fill);
        } else {
          nb = lane != 0 ? below : xt::to_compute(xr[p - 1]);
        }
        r[0] = xt::pair_op(op, nb, e[0]);
#pragma unroll
        for (int i = 1; i < VW; ++i) r[i] = xt::pair_op(op, e[i - 1], e[i]);
      } else {
        C nb;
        if (p + VW >= n) {
          C in = e[VW - 1];
          if (n > 1) {
            if constexpr (VW > 1) in = e[VW - 2];
            else if (bc == EXTRAPOLATE) in = xt::to_compute(xr[n - 2]);
          }
          const C wrap = bc == PERIODIC ? xt::to_compute(xr[0]) : e[VW - 1];
          nb = edge_value(bc, e[VW - 1], wrap, in, fill);
        } else {
          // the next lane holds the next vector of this row unless this
          // lane ends its segment
          nb = lane != width - 1 ? above : xt::to_compute(xr[p + VW]);
        }
#pragma unroll
        for (int i = 0; i < VW - 1; ++i) r[i] = xt::pair_op(op, e[i], e[i + 1]);
        r[VW - 1] = xt::pair_op(op, e[VW - 1], nb);
      }
      store_vec<T, VW>(outr + p, r);
    }
  }
}

// The edge row beside row 0 (before) or row n - 1 (after) of a plane: the
// boundary condition, from rows read again (one row of the plane).
template <typename T, int VW, typename I, typename C>
__device__ __forceinline__ void edge_row(C (&dst)[VW], const T* xp, I c, I n, I inner, bool after,
                                         int bc, C fill) {
  const I edge = after ? n - 1 : 0;
  C e[VW], wrap[VW], in[VW];
  load_vec<T, VW>(e, xp + edge * inner + c);
  if (bc == PERIODIC) load_vec<T, VW>(wrap, xp + (n - 1 - edge) * inner + c);
  const I inward = n == 1 ? edge : (after ? n - 2 : 1);
  if (bc == EXTRAPOLATE) load_vec<T, VW>(in, xp + inward * inner + c);
#pragma unroll
  for (int i = 0; i < VW; ++i)
    dst[i] = edge_value(bc, e[i], bc == PERIODIC ? wrap[i] : e[i],
                        bc == EXTRAPOLATE ? in[i] : e[i], fill);
}

// inner > 1: planes of (n, inner).  Block (tx, ty): tx threads along inner,
// one vector each, and ty batches of S rows.  A thread loads the S + 1 rows
// of its batch at once (S + 1 loads in flight) and writes S output rows.
template <typename T, int VW, int S, typename I>
__global__ void __launch_bounds__(kThreads)
shift_planes(const T* __restrict__ x, T* __restrict__ out, long long outer, I n, I inner, int op,
             int left, int bc, double fill_value) {
  using C = typename xt::Compute<T>::type;
  const C fill = xt::round_to<T>(fill_value);
  const I batches = (n + S - 1) / S;
  const long long plane = (long long)n * inner;
  for (long long o = blockIdx.z; o < outer; o += gridDim.z) {
    const T* xp = x + o * plane;
    T* outp = out + o * plane;
    for (I b = (I)blockIdx.y * (I)blockDim.y + (I)threadIdx.y; b < batches;
         b += (I)gridDim.y * (I)blockDim.y) {
      const I j0 = b * S;
      const I rows = n - j0 < S ? n - j0 : S;
      // w[k] is row q + k; the pair (w[k], w[k + 1]) gives output row
      // j0 + k.  The batch reads rows q .. q + rows; rows -1 and n are the
      // edge rows of the boundary condition
      const I q = j0 - left;
      for (I c = ((I)blockIdx.x * (I)blockDim.x + (I)threadIdx.x) * VW; c < inner;
           c += (I)gridDim.x * (I)blockDim.x * VW) {
        C w[S + 1][VW];
        if (q >= 0) {
          load_vec<T, VW>(w[0], xp + q * inner + c);
        } else {
          edge_row<T, VW>(w[0], xp, c, n, inner, false, bc, fill);
        }
#pragma unroll
        for (int k = 1; k <= S; ++k) {
          if (k <= rows && q + k < n) load_vec<T, VW>(w[k], xp + (q + k) * inner + c);
        }
#pragma unroll
        for (int k = 1; k <= S; ++k) {
          if (k <= rows && q + k == n) edge_row<T, VW>(w[k], xp, c, n, inner, true, bc, fill);
        }
#pragma unroll
        for (int k = 0; k < S; ++k) {
          if (k < rows) {
            C r[VW];
#pragma unroll
            for (int i = 0; i < VW; ++i) r[i] = xt::pair_op(op, w[k][i], w[k + 1][i]);
            store_vec<T, VW>(outp + (j0 + k) * inner + c, r);
          }
        }
      }
    }
  }
}

int pow2_at_least(long long v, int cap) {
  int p = 1;
  while (p < cap && p < v) p *= 2;
  return p;
}

unsigned int capped(long long v, long long cap) {
  return (unsigned int)(v < 1 ? 1 : (v > cap ? cap : v));
}

template <typename T, int VW, int S, typename I>
void launch_planes(const T* x, T* out, long long outer, long long n, long long inner, int op,
                   int left, int bc, double fill_value, cudaStream_t stream) {
  const long long nv = inner / VW;
  const int tx = pow2_at_least(nv, 32);
  const int ty = kThreads / tx;
  const long long batches = (n + S - 1) / S;
  const dim3 block(tx, ty);
  const dim3 grid(capped((nv + tx - 1) / tx, 0x7fffffffLL), capped((batches + ty - 1) / ty, 65535),
                  capped(outer, 65535));
  shift_planes<T, VW, S, I><<<grid, block, 0, stream>>>(x, out, outer, (I)n, (I)inner, op, left,
                                                         bc, fill_value);
}

template <typename T, int VW, typename I>
void launch_as(const T* x, T* out, long long outer, long long n, long long inner, int op,
               int left, int bc, double fill_value, cudaStream_t stream) {
  if (inner == 1) {
    const long long nv = n / VW;
    int tx = pow2_at_least(nv, 32);
    const int ty = pow2_at_least(outer, kThreads / tx);
    tx = kThreads / ty;
    const dim3 block(tx, ty);
    const dim3 grid(capped((nv + tx - 1) / tx, 0x7fffffffLL), capped((outer + ty - 1) / ty, 65535));
    shift_rows<T, VW, I><<<grid, block, 0, stream>>>(x, out, outer, (I)n, op, left, bc,
                                                      fill_value);
    return;
  }
  // the batch: 16 values of the compute type a thread (8 rows on the
  // scalar route)
  constexpr int kBatch = VW == 1 ? 8 : 16 / VW;
  launch_planes<T, VW, kBatch, I>(x, out, outer, n, inner, op, left, bc, fill_value, stream);
}

template <typename T>
void launch(const void* xv, void* outv, long long outer, long long n, long long inner, int op,
            int left, int bc, double fill_value, cudaStream_t stream) {
  if (outer == 0 || n == 0 || inner == 0) return;
  constexpr int VW = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const long long run = inner == 1 ? n : inner;
  const bool vec = run % VW == 0 &&
                   ((reinterpret_cast<unsigned long long>(x) |
                     reinterpret_cast<unsigned long long>(out)) & 15) == 0;
  // the elements of one row (inner == 1) or plane, and the neighbour row
  const bool narrow = (inner == 1 ? n : (n + 1) * inner) < kIndex32;
  if (vec && narrow) {
    launch_as<T, VW, int>(x, out, outer, n, inner, op, left, bc, fill_value, stream);
  } else if (vec) {
    launch_as<T, VW, long long>(x, out, outer, n, inner, op, left, bc, fill_value, stream);
  } else if (narrow) {
    launch_as<T, 1, int>(x, out, outer, n, inner, op, left, bc, fill_value, stream);
  } else {
    launch_as<T, 1, long long>(x, out, outer, n, inner, op, left, bc, fill_value, stream);
  }
}

}  // namespace

extern "C" int xt_shift(const void* x, void* out, int dtype, long long outer, long long n,
                        long long inner, int op, int direction, int bc, double fill_value,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int left = direction == 0;
  switch (dtype) {
    case xt::F32: launch<float>(x, out, outer, n, inner, op, left, bc, fill_value, s); break;
    case xt::F64: launch<double>(x, out, outer, n, inner, op, left, bc, fill_value, s); break;
    case xt::F16: launch<__half>(x, out, outer, n, inner, op, left, bc, fill_value, s); break;
    case xt::BF16:
      launch<__nv_bfloat16>(x, out, outer, n, inner, op, left, bc, fill_value, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
