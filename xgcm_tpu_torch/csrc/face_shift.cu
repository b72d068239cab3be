// Kernel E: the per-face shift stencil of the face-connected Grid fast path.
//
// Replaces: xgcm_tpu/ops/pallas_stencils.py, face_shift_op /
// _face_shift_x_kernel / _face_shift_y_kernel (and the semantics of its XLA
// twin, the concat formulation at the end of xgcm_tpu/ops/fused.py
// fused_face_shift_op).
//
// out = op(x, nb) along one axis of each face, where nb is x shifted by one
// within the face and the one wrapped edge line of each face is the
// caller's halo strip (the neighbour face's edge, already rotated, flipped,
// signed, or the basic boundary condition on unconnected edges).  x is a
// contiguous (..., F, ny, nx) array viewed as (outer, n, inner) along the
// roll axis: an x-axis op has inner = 1, outer = (...) * F * ny; a y-axis op
// has inner = nx, outer = (...) * F.  The contiguous (..., F, L) halo is then
// halo[o * inner + i] in both cases.
//
// Bound on the card: memory.  One read of x, one write of out, and the
// halo (1/n of x) per call; no arithmetic to speak of.  Design: no
// division per element, and 16-byte accesses wherever the layout allows
// them, on two routes chosen by the C entry below, which reports the one it
// took.
//
// * rows (inner == 1; face_shift_kernel_rows): a row of n contiguous
//   elements is cut into vectors of VW = 16 / sizeof(T) elements, one per
//   thread; the row comes from the block's y coordinate, the vector from
//   its x coordinate.  The one element that crosses a vector comes from the
//   neighbouring lane (__shfl_up_sync / __shfl_down_sync, in segments of
//   one row); the end lanes of a segment read it from memory.  Only the
//   row's first (left) or last (right) element takes the halo value,
//   halo[row], read once by the thread that owns that end.
// * planes (inner > 1; face_shift_kernel_planes): threads walk along inner,
//   one vector each, and take one batch of S rows of the (n, inner) plane,
//   loading its S + 1 input rows at once so that S + 1 loads are in flight;
//   x is read (S + 1) / S times, the extra row mostly from the L2.  The
//   neighbour of a vector is the whole aligned vector one row away; the
//   plane's edge row takes the vector of the halo line, halo[o * inner + c].
//   S holds 16 values of the compute type a thread (4 rows of float4; 8
//   rows on the scalar route).
//
// The vector form needs 16-byte aligned x and out (and halo on the planes
// route, which loads it in vectors) and a contiguous run (n, or inner) that
// is a multiple of VW; any other view runs the same kernels with VW = 1,
// one element a thread (the scalar route).  Offsets inside a row or plane
// are 32-bit, on a 64-bit base per row or plane; a row or plane of
// 2^31 - 2^13 elements or more takes the 64-bit instantiation.  16-bit
// types load into float and round once at the store; double computes in
// double.  Every output word equals the one-thread-an-element form's: the
// same xt::pair_op on the same operands in the same compute type.
//
// Kernel A (shift.cu) has the same two routes; E keeps its own kernels,
// since A's edge is a boundary condition taken from the row itself
// (periodic, fill, extend, extrapolate) where E's is a line the caller
// passes, and A runs in other paths that must not change with E.
#include "common.cuh"

namespace {

// The routes the C entry reports (ROUTES in ops/kernels/face_shift.py).
enum Route : int { ROWS = 0, PLANES = 1, SCALAR = 2 };

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

// inner == 1: rows of n contiguous elements, one vector of VW a thread.
// Block (tx, ty): tx threads along a row (a power of two), ty rows; the
// shuffles run in segments of min(tx, 32) lanes, each within one row.
template <typename T, int VW, typename I>
__global__ void __launch_bounds__(kThreads)
face_shift_kernel_rows(const T* __restrict__ x, const T* __restrict__ halo, T* __restrict__ out,
                       long long outer, I n, int op, int left) {
  using C = typename xt::Compute<T>::type;
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
        const C nb = p == 0 ? xt::to_compute(halo[row])
                            : (lane != 0 ? below : xt::to_compute(xr[p - 1]));
        r[0] = xt::pair_op(op, nb, e[0]);
#pragma unroll
        for (int i = 1; i < VW; ++i) r[i] = xt::pair_op(op, e[i - 1], e[i]);
      } else {
        // the next lane holds the next vector of this row unless this lane
        // ends its segment
        const C nb = p + VW >= n ? xt::to_compute(halo[row])
                                 : (lane != width - 1 ? above : xt::to_compute(xr[p + VW]));
#pragma unroll
        for (int i = 0; i < VW - 1; ++i) r[i] = xt::pair_op(op, e[i], e[i + 1]);
        r[VW - 1] = xt::pair_op(op, e[VW - 1], nb);
      }
      store_vec<T, VW>(outr + p, r);
    }
  }
}

// inner > 1: planes of (n, inner).  Block (tx, ty): tx threads along inner,
// one vector each, and ty batches of S rows.  A thread loads the S + 1 rows
// of its batch at once (S + 1 loads in flight) and writes S output rows.
template <typename T, int VW, int S, typename I>
__global__ void __launch_bounds__(kThreads)
face_shift_kernel_planes(const T* __restrict__ x, const T* __restrict__ halo,
                         T* __restrict__ out, long long outer, I n, I inner, int op, int left) {
  using C = typename xt::Compute<T>::type;
  const I batches = (n + S - 1) / S;
  const long long plane = (long long)n * inner;
  for (long long o = blockIdx.z; o < outer; o += gridDim.z) {
    const T* xp = x + o * plane;
    const T* hp = halo + o * (long long)inner;
    T* outp = out + o * plane;
    for (I b = (I)blockIdx.y * (I)blockDim.y + (I)threadIdx.y; b < batches;
         b += (I)gridDim.y * (I)blockDim.y) {
      const I j0 = b * S;
      const I rows = n - j0 < S ? n - j0 : S;
      // w[k] is row q + k; the pair (w[k], w[k + 1]) gives output row
      // j0 + k.  The batch reads rows q .. q + rows; row -1 (left) or n
      // (right) is the halo line
      const I q = j0 - left;
      for (I c = ((I)blockIdx.x * (I)blockDim.x + (I)threadIdx.x) * VW; c < inner;
           c += (I)gridDim.x * (I)blockDim.x * VW) {
        C w[S + 1][VW];
#pragma unroll
        for (int k = 0; k <= S; ++k) {
          if (k <= rows) {
            const I j = q + k;
            load_vec<T, VW>(w[k], j >= 0 && j < n ? xp + j * inner + c : hp + c);
          }
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

template <typename T, int VW, typename I>
void launch_as(const T* x, const T* halo, T* out, long long outer, long long n, long long inner,
               int op, int left, cudaStream_t stream) {
  if (inner == 1) {
    const long long nv = n / VW;
    int tx = pow2_at_least(nv, 32);
    const int ty = pow2_at_least(outer, kThreads / tx);
    tx = kThreads / ty;
    const dim3 block(tx, ty);
    const dim3 grid(capped((nv + tx - 1) / tx, 0x7fffffffLL), capped((outer + ty - 1) / ty, 65535));
    face_shift_kernel_rows<T, VW, I><<<grid, block, 0, stream>>>(x, halo, out, outer, (I)n, op,
                                                                  left);
    return;
  }
  // the batch: 16 values of the compute type a thread (8 rows on the
  // scalar route)
  constexpr int S = VW == 1 ? 8 : 16 / VW;
  const long long nv = inner / VW;
  const int tx = pow2_at_least(nv, 32);
  const int ty = kThreads / tx;
  const long long batches = (n + S - 1) / S;
  const dim3 block(tx, ty);
  const dim3 grid(capped((nv + tx - 1) / tx, 0x7fffffffLL), capped((batches + ty - 1) / ty, 65535),
                  capped(outer, 65535));
  face_shift_kernel_planes<T, VW, S, I><<<grid, block, 0, stream>>>(x, halo, out, outer, (I)n,
                                                                     (I)inner, op, left);
}

// Launches the kernel and returns the route it took, or -1 for an empty
// array (no launch).
template <typename T>
int launch(const void* xv, const void* hv, void* outv, long long outer, long long n,
           long long inner, int op, int left, cudaStream_t stream) {
  if (outer == 0 || n == 0 || inner == 0) return -1;
  constexpr int VW = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  const T* halo = static_cast<const T*>(hv);
  T* out = static_cast<T*>(outv);
  const bool rows = inner == 1;
  const long long run = rows ? n : inner;
  // the rows route reads the halo one element a row, the planes route in
  // vectors
  const unsigned long long ptrs = reinterpret_cast<unsigned long long>(x) |
                                  reinterpret_cast<unsigned long long>(out) |
                                  (rows ? 0ULL : reinterpret_cast<unsigned long long>(halo));
  const bool vec = run % VW == 0 && (ptrs & 15) == 0;
  // the elements of one row (inner == 1) or plane, and the neighbour row
  const bool narrow = (rows ? n : (n + 1) * inner) < kIndex32;
  if (vec && narrow) {
    launch_as<T, VW, int>(x, halo, out, outer, n, inner, op, left, stream);
  } else if (vec) {
    launch_as<T, VW, long long>(x, halo, out, outer, n, inner, op, left, stream);
  } else if (narrow) {
    launch_as<T, 1, int>(x, halo, out, outer, n, inner, op, left, stream);
  } else {
    launch_as<T, 1, long long>(x, halo, out, outer, n, inner, op, left, stream);
  }
  return !vec ? SCALAR : (rows ? ROWS : PLANES);
}

}  // namespace

extern "C" int xt_face_shift(const void* x, const void* halo, void* out, int dtype,
                             long long outer, long long n, long long inner, int op,
                             int direction, int* route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int left = direction == 0;
  switch (dtype) {
    case xt::F32: *route = launch<float>(x, halo, out, outer, n, inner, op, left, s); break;
    case xt::F64: *route = launch<double>(x, halo, out, outer, n, inner, op, left, s); break;
    case xt::F16: *route = launch<__half>(x, halo, out, outer, n, inner, op, left, s); break;
    case xt::BF16:
      *route = launch<__nv_bfloat16>(x, halo, out, outer, n, inner, op, left, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
