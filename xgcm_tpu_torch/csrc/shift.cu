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
// element (the neighbour read hits the same or the adjacent cache line), no
// arithmetic to speak of.  Design: one thread per output element in a
// grid-stride loop; neighbouring threads take neighbouring elements, so
// loads and stores coalesce for every axis (the shift moves by `inner`
// elements, never across threads of a warp when inner == 1 except by one
// element).  16-bit types load into float and round once at the store.
#include "common.cuh"

namespace {

enum Bc : int { PERIODIC = 0, FILL = 1, EXTEND = 2, EXTRAPOLATE = 3 };

template <typename T>
__global__ void shift_kernel(const T* __restrict__ x, T* __restrict__ out,
                             long long total, long long n, long long inner,
                             int op, int left, int bc, double fill_value) {
  using C = typename xt::Compute<T>::type;
  const C fill = xt::round_to<T>(fill_value);
  const long long wrap = (n - 1) * inner;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long i = (idx / inner) % n;
    const C xv = xt::to_compute(x[idx]);
    const bool edge = left ? (i == 0) : (i == n - 1);
    C nb;
    if (!edge) {
      nb = xt::to_compute(x[left ? idx - inner : idx + inner]);
    } else if (bc == FILL) {
      nb = fill;
    } else if (bc == EXTEND) {
      nb = xv;
    } else if (bc == EXTRAPOLATE) {
      // the inward neighbour of the edge, as a roll by one away from it
      const long long in_idx = (n == 1) ? idx : (left ? idx + inner : idx - inner);
      nb = C(2) * xv - xt::to_compute(x[in_idx]);
    } else {  // PERIODIC
      nb = xt::to_compute(x[left ? idx + wrap : idx - wrap]);
    }
    const C r = left ? xt::pair_op(op, nb, xv) : xt::pair_op(op, xv, nb);
    out[idx] = xt::from_compute<T>(r);
  }
}

template <typename T>
void launch(const void* x, void* out, long long outer, long long n, long long inner,
            int op, int left, int bc, double fill_value, cudaStream_t stream) {
  const long long total = outer * n * inner;
  if (total == 0) return;
  const int threads = 256;
  shift_kernel<T><<<xt::blocks_for(total, threads), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), total, n, inner, op, left,
      bc, fill_value);
}

}  // namespace

extern "C" int xt_shift(const void* x, void* out, int dtype, long long outer,
                        long long n, long long inner, int op, int direction,
                        int bc, double fill_value, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int left = direction == 0;
  switch (dtype) {
    case xt::F32: launch<float>(x, out, outer, n, inner, op, left, bc, fill_value, s); break;
    case xt::F64: launch<double>(x, out, outer, n, inner, op, left, bc, fill_value, s); break;
    case xt::F16: launch<__half>(x, out, outer, n, inner, op, left, bc, fill_value, s); break;
    case xt::BF16: launch<__nv_bfloat16>(x, out, outer, n, inner, op, left, bc, fill_value, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
