// Kernel C: linear interpolation of raw columns onto target levels (the
// linear/log vertical transform).
//
// Replaces: xgcm_tpu/ops/pallas_transform.py, interp_linear_fused_T /
// _fused_kernel (and its fronts interp_linear_fused, interp_linear_fused_ad,
// interp_linear_fused_T_ad).  Semantics are those of _fused_ref_jnp there,
// which the Pallas kernel matches:
//   * per-column direction from the first and last valid knot, applied by
//     negation (theta_eff = theta * dsign, t_eff = t * dsign);
//   * NaN theta knots are +inf in effective space and never selected;
//   * the selected interval k is the one with theta_eff[k] <= t_eff <
//     theta_eff[k+1]; on a monotone column that is the last knot with
//     theta_eff <= t_eff (last writer wins on duplicate knots);
//   * NaN phi at a valid knot turns the targets of the intervals touching it
//     into NaN;
//   * t < th_min clamps to the phi at the min-theta end, t >= th_max to the
//     phi at the max-theta end; all-NaN columns give NaN; mask_edges turns
//     targets outside [th_min, th_max] into NaN.
// The TPU workarounds of the Pallas kernel (a finite 3e38 sentinel, slopes
// folded with 1e35 to carry the NaN flag, all because the TPU gives
// 0 * inf = NaN inside masked sums) are not carried over: this kernel selects
// with branches, keeps +inf and a separate NaN flag.  On a non-monotone
// column every matching interval contributes, as in _fused_ref_jnp's
// membership sums, so the kernel agrees with its plain version everywhere.
//
// Bound on the card: memory, (2n + m) * cols * itemsize bytes when theta,
// phi and the output are all distinct (a phi broadcast along the column,
// knot stride 0, reads one value per column).  Design: one thread per
// column; a first pass over the knots finds the first/last valid knot and
// the range, then each target scans the knots again.  Columns are addressed
// through (column, knot) strides, so (cols, n) and lanes-major (n, cols)
// views and broadcast views all run without a copy; the lanes-major layout
// (column stride 1) is the coalesced one.  Arithmetic is float; 16-bit
// inputs widen at the load and the output rounds once at the store.
#include <math.h>

#include <cfloat>

#include "common.cuh"

namespace {

template <typename TH, typename PH>
__global__ void interp_linear_kernel(
    const TH* __restrict__ th, const PH* __restrict__ ph, const float* __restrict__ tg,
    PH* __restrict__ out, long long cols, long long n, long long m,
    long long th_cs, long long th_ks, long long ph_cs, long long ph_ks,
    long long t_cs, long long t_ms, long long o_cs, long long o_ms,
    int mask_edges, int check_flip) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const TH* thc = th + c * th_cs;
  const PH* phc = ph + c * ph_cs;
  const float* tc = tg + c * t_cs;
  PH* oc = out + c * o_cs;
  const float inf = INFINITY;
  const float nan = NAN;

  // pass 1: first/last valid knot and the valid range
  long long first = -1, last = -1;
  float th_min = inf, th_max = -inf;
  for (long long k = 0; k < n; ++k) {
    const float v = xt::to_compute(thc[k * th_ks]);
    if (!isnan(v)) {
      if (first < 0) first = k;
      last = k;
      th_min = fminf(th_min, v);
      th_max = fmaxf(th_max, v);
    }
  }
  if (first < 0) {  // all-NaN column
    for (long long j = 0; j < m; ++j) oc[j * o_ms] = xt::from_compute<PH>(nan);
    return;
  }
  const float first_ph = xt::to_compute(phc[first * ph_ks]);
  const float last_ph = xt::to_compute(phc[last * ph_ks]);
  bool desc = false;
  if (check_flip) {
    // compared as nan_to_num would leave them (infinities clamp to FLT_MAX)
    const float f = fminf(fmaxf(xt::to_compute(thc[first * th_ks]), -FLT_MAX), FLT_MAX);
    const float l = fminf(fmaxf(xt::to_compute(thc[last * th_ks]), -FLT_MAX), FLT_MAX);
    desc = l < f;
  }
  const float dsign = desc ? -1.0f : 1.0f;
  const float lo_ph = desc ? last_ph : first_ph;
  const float hi_ph = desc ? first_ph : last_ph;

  for (long long j = 0; j < m; ++j) {
    const float t = tc[j * t_ms];
    const float te = t * dsign;
    float acc_ph = 0.0f, acc_th = 0.0f, acc_s = 0.0f;
    bool nan_sel = false;
    // knot k in effective space: valid -> theta * dsign, NaN -> +inf
    float th_raw = xt::to_compute(thc[0]);
    float th_k = isnan(th_raw) ? inf : th_raw * dsign;
    for (long long k = 0; k < n; ++k) {
      float th_k1 = inf;
      float th1_raw = nan;
      if (k + 1 < n) {
        th1_raw = xt::to_compute(thc[(k + 1) * th_ks]);
        th_k1 = isnan(th1_raw) ? inf : th1_raw * dsign;
      }
      if (th_k <= te && !(th_k1 <= te)) {
        const float p_raw = xt::to_compute(phc[k * ph_ks]);
        const float p1_raw = (k + 1 < n) ? xt::to_compute(phc[(k + 1) * ph_ks]) : 0.0f;
        const float p = isnan(p_raw) ? 0.0f : p_raw;
        const float p1 = isnan(p1_raw) ? 0.0f : p1_raw;
        const float dth = th_k1 - th_k;
        const float slope = (dth > 0.0f && dth < inf) ? (p1 - p) / dth : 0.0f;
        acc_ph += p;
        acc_th += th_k;
        acc_s += slope;
        // NaN data at a valid knot (k or k+1) propagates into this interval
        nan_sel |= (isnan(p_raw) && !isnan(th_raw)) ||
                   (k + 1 < n && isnan(p1_raw) && !isnan(th1_raw));
      }
      th_raw = th1_raw;
      th_k = th_k1;
    }
    float r = acc_ph + (te - acc_th) * acc_s;
    if (nan_sel) r = nan;
    if (t < th_min) r = lo_ph;
    if (t >= th_max) r = hi_ph;
    if (mask_edges && (t < th_min || t > th_max)) r = nan;
    oc[j * o_ms] = xt::from_compute<PH>(r);
  }
}

template <typename TH, typename PH>
void launch(const void* th, const void* ph, const void* tg, void* out, long long cols,
            long long n, long long m, long long th_cs, long long th_ks, long long ph_cs,
            long long ph_ks, long long t_cs, long long t_ms, long long o_cs, long long o_ms,
            int mask_edges, int check_flip, cudaStream_t stream) {
  if (cols == 0 || m == 0) return;
  const int threads = 128;
  interp_linear_kernel<TH, PH><<<xt::blocks_for(cols, threads), threads, 0, stream>>>(
      static_cast<const TH*>(th), static_cast<const PH*>(ph), static_cast<const float*>(tg),
      static_cast<PH*>(out), cols, n, m, th_cs, th_ks, ph_cs, ph_ks, t_cs, t_ms, o_cs, o_ms,
      mask_edges, check_flip);
}

}  // namespace

extern "C" int xt_interp_linear(const void* th, const void* ph, const void* tg, void* out,
                                int th_dtype, int ph_dtype, long long cols, long long n,
                                long long m, long long th_cs, long long th_ks,
                                long long ph_cs, long long ph_ks, long long t_cs,
                                long long t_ms, long long o_cs, long long o_ms,
                                int mask_edges, int check_flip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define XT_ARGS th, ph, tg, out, cols, n, m, th_cs, th_ks, ph_cs, ph_ks, t_cs, t_ms, o_cs, \
                o_ms, mask_edges, check_flip, s
  if (th_dtype == xt::F32 && ph_dtype == xt::F32) {
    launch<float, float>(XT_ARGS);
  } else if (th_dtype == xt::F32 && ph_dtype == xt::BF16) {
    launch<float, __nv_bfloat16>(XT_ARGS);
  } else if (th_dtype == xt::BF16 && ph_dtype == xt::F32) {
    launch<__nv_bfloat16, float>(XT_ARGS);
  } else if (th_dtype == xt::BF16 && ph_dtype == xt::BF16) {
    launch<__nv_bfloat16, __nv_bfloat16>(XT_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef XT_ARGS
  return (int)cudaGetLastError();
}
