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
// halo[o * inner + i] in both cases, so one launch shape serves both axes
// and any leading batch dims.
//
// Bound on the card: memory.  One read of x, one write of out, and the
// halo (1/L of x) per call; no arithmetic to speak of.  Design: one thread
// per output element, neighbouring threads on neighbouring elements, so
// loads and stores coalesce on both axes and the neighbour read hits the
// same or an adjacent cache line; the index arithmetic runs in 32 bits
// whenever the array has fewer than 2^30 elements (a 13 x 4320^2 LLC4320
// level has 2.4e8), so that no index of the grid-stride loop overflows.
// 16-bit types load into float and round once at the store; double
// computes in double.
#include "common.cuh"

namespace {

template <typename T, typename I>
__global__ void face_shift_kernel(const T* __restrict__ x, const T* __restrict__ halo,
                                  T* __restrict__ out, I total, I n, I inner, int op,
                                  int left) {
  using C = typename xt::Compute<T>::type;
  for (I idx = blockIdx.x * (I)blockDim.x + threadIdx.x; idx < total;
       idx += (I)gridDim.x * blockDim.x) {
    const I i = idx % inner;
    const I row = idx / inner;  // o * n + j
    const I j = row % n;
    const C xv = xt::to_compute(x[idx]);
    const bool edge = left ? (j == 0) : (j == n - 1);
    const C nb = edge ? xt::to_compute(halo[(row / n) * inner + i])
                      : xt::to_compute(x[left ? idx - inner : idx + inner]);
    const C r = left ? xt::pair_op(op, nb, xv) : xt::pair_op(op, xv, nb);
    out[idx] = xt::from_compute<T>(r);
  }
}

template <typename T>
void launch(const void* x, const void* halo, void* out, long long outer, long long n,
            long long inner, int op, int left, cudaStream_t stream) {
  const long long total = outer * n * inner;
  if (total == 0) return;
  const int threads = 256;
  const unsigned int blocks = xt::blocks_for(total, threads);
  const T* xp = static_cast<const T*>(x);
  const T* hp = static_cast<const T*>(halo);
  T* o = static_cast<T*>(out);
  if (total < (1LL << 30)) {
    face_shift_kernel<T, unsigned int><<<blocks, threads, 0, stream>>>(
        xp, hp, o, (unsigned int)total, (unsigned int)n, (unsigned int)inner, op, left);
  } else {
    face_shift_kernel<T, long long><<<blocks, threads, 0, stream>>>(
        xp, hp, o, total, n, inner, op, left);
  }
}

}  // namespace

extern "C" int xt_face_shift(const void* x, const void* halo, void* out, int dtype,
                             long long outer, long long n, long long inner, int op,
                             int direction, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int left = direction == 0;
  switch (dtype) {
    case xt::F32: launch<float>(x, halo, out, outer, n, inner, op, left, s); break;
    case xt::F64: launch<double>(x, halo, out, outer, n, inner, op, left, s); break;
    case xt::F16: launch<__half>(x, halo, out, outer, n, inner, op, left, s); break;
    case xt::BF16: launch<__nv_bfloat16>(x, halo, out, outer, n, inner, op, left, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
