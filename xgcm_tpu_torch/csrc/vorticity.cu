// Kernel D: periodic C-grid relative vorticity alone.
//
// Replaces: xgcm_tpu/ops/pallas_stencils.py, fused_vorticity /
// _vorticity_kernel.
//
// u on (yc, xg), v on (yg, xc), both (ny, nx), periodic in x and y:
//   zeta[j,i] = (v[j,i]-v[j,i-1])*inv_dx[i] - (u[j,i]-u[j-1,i])*inv_dy[j]
//
// Bound on the card: memory.  Two reads (u, v) and one write (zeta) per
// point, where the Grid API's two shifts and the subtraction move seven
// arrays.  Design: kernel B's with the divergence and kinetic energy
// left out: one thread per point on a 2-D launch of 32 x 8 blocks; a warp
// covers 32 neighbouring columns of one row, so every load and store
// coalesces, and the x/y neighbours come from the same or the row above,
// which the L1 and L2 caches hold.  Inputs widen to float (double for f64)
// and zeta rounds once at the store.
#include "common.cuh"

namespace {

template <typename T>
__global__ void vorticity_kernel(const T* __restrict__ u, const T* __restrict__ v,
                                 const typename xt::Compute<T>::type* __restrict__ ix,
                                 const typename xt::Compute<T>::type* __restrict__ iy,
                                 T* __restrict__ zeta, long long ny, long long nx) {
  using C = typename xt::Compute<T>::type;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long j = blockIdx.y * (long long)blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const long long im = (i == 0) ? nx - 1 : i - 1;
  const long long jm = (j == 0) ? ny - 1 : j - 1;
  const long long at = j * nx + i;

  const C u0 = xt::to_compute(u[at]);
  const C v0 = xt::to_compute(v[at]);
  const C u_ym = xt::to_compute(u[jm * nx + i]);
  const C v_xm = xt::to_compute(v[j * nx + im]);
  zeta[at] = xt::from_compute<T>((v0 - v_xm) * ix[i] - (u0 - u_ym) * iy[j]);
}

template <typename T>
void launch(const void* u, const void* v, const void* ix, const void* iy, void* zeta,
            long long ny, long long nx, cudaStream_t stream) {
  using C = typename xt::Compute<T>::type;
  if (ny == 0 || nx == 0) return;
  const dim3 threads(32, 8);
  const dim3 blocks(xt::blocks_for(nx, 32), xt::blocks_for(ny, 8));
  vorticity_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const C*>(ix),
      static_cast<const C*>(iy), static_cast<T*>(zeta), ny, nx);
}

}  // namespace

extern "C" int xt_vorticity(const void* u, const void* v, const void* ix, const void* iy,
                            void* zeta, int dtype, long long ny, long long nx,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case xt::F32: launch<float>(u, v, ix, iy, zeta, ny, nx, s); break;
    case xt::F64: launch<double>(u, v, ix, iy, zeta, ny, nx, s); break;
    case xt::BF16: launch<__nv_bfloat16>(u, v, ix, iy, zeta, ny, nx, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
