// Kernels G and H: conservative rebin of raw cell columns into shared bins
// (the conservative vertical transform), for one variable (G) or for up to
// eight variables that share the cell geometry (H).
//
// Replaces: xgcm_tpu/ops/pallas_transform.py, conservative_fused_T /
// _conservative_kernel (G; fronts conservative_fused, conservative_fused_ad,
// conservative_fused_T_ad) and conservative_fused_multi_T /
// _conservative_multi_kernel (H; fronts conservative_fused_multi, its _ad and
// conservative_fused_multi_T_ad).  Semantics are those of the jnp twin
// xgcm_tpu/ops/transform.py _conservative_rebin followed by the
// untouched-bin -> NaN rule:
//   * a cell k spans the raw bounds theta[k], theta[k+1]; a cell with both
//     bounds NaN is empty, a cell with one NaN bound is degenerate at the
//     other; a cell whose datum is NaN contributes nothing;
//   * bin j = [e_j, e_{j+1}] receives w_k * (frac_k(e_{j+1}) - frac_k(e_j)),
//     frac_k(x) = clip((x - tmin_k) / thick_k, 0, 1), w_k the datum with
//     +-inf as +-FLT_MAX (nan_to_num);
//   * a degenerate cell (thick == 0) steps instead: (e_{j+1} >= tmin) at the
//     upper edge and (e_j > tmin) at the lower, so a cell exactly on an
//     interior edge counts into both bins, as the reference does;
//   * a bin no valid cell overlaps (tmin <= e_{j+1} and tmax >= e_j) is NaN.
// The TPU kernel's sentinels (invalid cells parked at 1e38, degenerate cells
// folded into the mass term with a 3e38 slope) exist because the TPU has no
// cheap per-lane branch; here each thread branches per cell, so the twin's
// own branches run instead.  In H the geometry of a cell depends on theta
// only, and each variable's validity enters only through its weight and its
// count, as in _conservative_multi_kernel.
//
// reassociate selects the telescoped accumulator: F(e_{j+1}) and F(e_j) are
// summed separately and subtracted once, which differs from the default by
// float summation order only.
//
// Bound on the card: memory, ((n + 1) + V n) * cols * itemsize bytes read and
// V (m - 1) * cols written.  Design: one thread per (column, bin); the
// threads of a warp walk the bins of one or two columns, so with the
// (y, x, z) layout users keep (level stride 1) a warp's loads of a column
// hit one cache line and its stores are contiguous.  Each thread walks the
// n cells once; a column's bounds and data are read by all m - 1 of its bin
// threads, from L1/L2.  Arithmetic is float; 16-bit inputs widen at the
// load and the output rounds once at the store.
#include <math.h>

#include <cfloat>

#include "common.cuh"

namespace {

template <int NV, typename TH, typename PH>
__global__ void conservative_kernel(const TH* __restrict__ th, const xt::VarSet<PH> vars,
                                    const float* __restrict__ edges, long long cols, long long n,
                                    long long nb, long long th_cs, long long th_ks,
                                    long long o_cs, long long o_js, int reassoc) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= cols * nb) return;
  const long long c = idx / nb;
  const long long j = idx - c * nb;
  const float lo = edges[j];
  const float hi = edges[j + 1];
  const TH* thc = th + c * th_cs;
  const PH* phc[NV];
  // acc: the bin's mass (F(e_{j+1}) when reassociating); acc_lo: F(e_j)
  float acc[NV], acc_lo[NV], cnt[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    phc[v] = vars.in[v] + c * vars.cs[v];
    acc[v] = 0.0f;
    acc_lo[v] = 0.0f;
    cnt[v] = 0.0f;
  }

  float t1 = xt::to_compute(thc[0]);
  for (long long k = 0; k < n; ++k) {
    const float t2 = xt::to_compute(thc[(k + 1) * th_ks]);
    const bool n1 = isnan(t1), n2 = isnan(t2);
    if (!(n1 && n2)) {
      const float tmin = n1 ? t2 : (n2 ? t1 : fminf(t1, t2));
      const float tmax = n1 ? t2 : (n2 ? t1 : fmaxf(t1, t2));
      const float thick = tmax - tmin;
      float f_up, f_lo;
      if (thick == 0.0f) {
        f_up = hi >= tmin ? 1.0f : 0.0f;
        f_lo = lo > tmin ? 1.0f : 0.0f;
      } else {
        const float inv = 1.0f / thick;
        f_up = fminf(fmaxf((hi - tmin) * inv, 0.0f), 1.0f);
        f_lo = fminf(fmaxf((lo - tmin) * inv, 0.0f), 1.0f);
      }
      const bool overlap = (tmin <= hi) && !(tmax < lo);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float p = xt::to_compute(phc[v][k * vars.ks[v]]);
        if (isnan(p)) continue;
        const float w = isinf(p) ? copysignf(FLT_MAX, p) : p;
        if (reassoc) {
          acc[v] += w * f_up;
          acc_lo[v] += w * f_lo;
        } else {
          acc[v] += w * (f_up - f_lo);
        }
        if (overlap) cnt[v] += 1.0f;
      }
    }
    t1 = t2;
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float r = reassoc ? acc[v] - acc_lo[v] : acc[v];
    vars.out[v][c * o_cs + j * o_js] = xt::from_compute<PH>(cnt[v] > 0.0f ? r : NAN);
  }
}

template <int NV, typename TH, typename PH>
void launch(const void* th, const xt::VarSet<PH>& vars, const float* edges, long long cols,
            long long n, long long nb, long long th_cs, long long th_ks, long long o_cs,
            long long o_js, int reassoc, cudaStream_t stream) {
  const int threads = 256;
  conservative_kernel<NV, TH, PH><<<xt::blocks_for(cols * nb, threads), threads, 0, stream>>>(
      static_cast<const TH*>(th), vars, edges, cols, n, nb, th_cs, th_ks, o_cs, o_js, reassoc);
}

template <typename TH, typename PH>
int dispatch(int nv, const void* th, const void* const* phs, const long long* ph_cs,
             const long long* ph_ks, void* const* outs, const float* edges, long long cols,
             long long n, long long nb, long long th_cs, long long th_ks, long long o_cs,
             long long o_js, int reassoc, cudaStream_t s) {
  const xt::VarSet<PH> vars = xt::make_varset<PH>(nv, phs, ph_cs, ph_ks, outs);
#define XT_ARGS th, vars, edges, cols, n, nb, th_cs, th_ks, o_cs, o_js, reassoc, s
  switch (nv) {
    case 1: launch<1, TH, PH>(XT_ARGS); break;
    case 2: launch<2, TH, PH>(XT_ARGS); break;
    case 3: launch<3, TH, PH>(XT_ARGS); break;
    case 4: launch<4, TH, PH>(XT_ARGS); break;
    case 5: launch<5, TH, PH>(XT_ARGS); break;
    case 6: launch<6, TH, PH>(XT_ARGS); break;
    case 7: launch<7, TH, PH>(XT_ARGS); break;
    case 8: launch<8, TH, PH>(XT_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef XT_ARGS
  return 0;
}

}  // namespace

// nv = 1 is kernel G, 2 <= nv <= 8 kernel H.  phs/ph_cs/ph_ks/outs are host
// arrays of nv entries; every datum shares ph_dtype, every output is
// (cols, nb) in that dtype with strides (o_cs, o_js); edges are nb + 1
// increasing float32 values on the card.
extern "C" int xt_conservative(const void* th, const void* const* phs, const long long* ph_cs,
                               const long long* ph_ks, void* const* outs, const void* edges,
                               int nv, int th_dtype, int ph_dtype, long long cols, long long n,
                               long long nb, long long th_cs, long long th_ks, long long o_cs,
                               long long o_js, int reassoc, void* stream) {
  if (cols == 0 || nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* e = static_cast<const float*>(edges);
#define XT_ARGS nv, th, phs, ph_cs, ph_ks, outs, e, cols, n, nb, th_cs, th_ks, o_cs, o_js, \
                reassoc, s
  int status;
  if (th_dtype == xt::F32 && ph_dtype == xt::F32) {
    status = dispatch<float, float>(XT_ARGS);
  } else if (th_dtype == xt::F32 && ph_dtype == xt::BF16) {
    status = dispatch<float, __nv_bfloat16>(XT_ARGS);
  } else if (th_dtype == xt::BF16 && ph_dtype == xt::F32) {
    status = dispatch<__nv_bfloat16, float>(XT_ARGS);
  } else if (th_dtype == xt::BF16 && ph_dtype == xt::BF16) {
    status = dispatch<__nv_bfloat16, __nv_bfloat16>(XT_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef XT_ARGS
  if (status != 0) return status;
  return (int)cudaGetLastError();
}
