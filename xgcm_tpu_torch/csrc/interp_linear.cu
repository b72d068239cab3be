// Kernels C and F: linear interpolation of raw columns onto target levels
// (the linear/log vertical transform), for one variable (C) or for up to
// eight variables that share theta and the interval selection (F).
//
// Replaces: xgcm_tpu/ops/pallas_transform.py, interp_linear_fused_T /
// _fused_kernel (C; fronts interp_linear_fused, interp_linear_fused_ad,
// interp_linear_fused_T_ad) and interp_linear_fused_multi_T /
// _fused_multi_kernel (F; fronts interp_linear_fused_multi,
// interp_linear_fused_multi_ad, interp_linear_fused_multi_T_ad).  Semantics
// are those of _fused_ref_jnp there, per variable:
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
// membership sums, so the kernel agrees with its plain version everywhere;
// F does the same per variable, so on every column it gives what V calls of
// C give (the TPU multi kernel's last-writer-wins select is not carried
// over).  In F the knot compares, the interval and the theta sums are
// shared; each variable adds its own phi reads, slope and NaN flag.
//
// Bound on the card: memory, ((1 + V) n + V m) * cols * itemsize bytes when
// theta, the V phis and the outputs are all distinct (a phi broadcast along
// the column, knot stride 0, reads one value per column).  Design: one thread per
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

template <int NV, typename TH, typename PH>
__global__ void interp_linear_kernel(
    const TH* __restrict__ th, const xt::VarSet<PH> vars, const float* __restrict__ tg,
    long long cols, long long n, long long m, long long th_cs, long long th_ks,
    long long t_cs, long long t_ms, long long o_cs, long long o_ms,
    int mask_edges, int check_flip) {
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const TH* thc = th + c * th_cs;
  const float* tc = tg + c * t_cs;
  const PH* phc[NV];
  PH* oc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    phc[v] = vars.in[v] + c * vars.cs[v];
    oc[v] = vars.out[v] + c * o_cs;
  }
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
    for (long long j = 0; j < m; ++j) {
#pragma unroll
      for (int v = 0; v < NV; ++v) oc[v][j * o_ms] = xt::from_compute<PH>(nan);
    }
    return;
  }
  bool desc = false;
  if (check_flip) {
    // compared as nan_to_num would leave them (infinities clamp to FLT_MAX)
    const float f = fminf(fmaxf(xt::to_compute(thc[first * th_ks]), -FLT_MAX), FLT_MAX);
    const float l = fminf(fmaxf(xt::to_compute(thc[last * th_ks]), -FLT_MAX), FLT_MAX);
    desc = l < f;
  }
  const float dsign = desc ? -1.0f : 1.0f;
  float lo_ph[NV], hi_ph[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float first_ph = xt::to_compute(phc[v][first * vars.ks[v]]);
    const float last_ph = xt::to_compute(phc[v][last * vars.ks[v]]);
    lo_ph[v] = desc ? last_ph : first_ph;
    hi_ph[v] = desc ? first_ph : last_ph;
  }

  for (long long j = 0; j < m; ++j) {
    const float t = tc[j * t_ms];
    const float te = t * dsign;
    float acc_th = 0.0f;
    float acc_ph[NV], acc_s[NV];
    bool nan_sel[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      acc_ph[v] = 0.0f;
      acc_s[v] = 0.0f;
      nan_sel[v] = false;
    }
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
        const float dth = th_k1 - th_k;
        const bool ok = dth > 0.0f && dth < inf;
        acc_th += th_k;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const PH* pv = phc[v];
          const long long ks = vars.ks[v];
          const float p_raw = xt::to_compute(pv[k * ks]);
          const float p1_raw = (k + 1 < n) ? xt::to_compute(pv[(k + 1) * ks]) : 0.0f;
          const float p = isnan(p_raw) ? 0.0f : p_raw;
          const float p1 = isnan(p1_raw) ? 0.0f : p1_raw;
          acc_ph[v] += p;
          acc_s[v] += ok ? (p1 - p) / dth : 0.0f;
          // NaN data at a valid knot (k or k+1) propagates into this interval
          nan_sel[v] |= (isnan(p_raw) && !isnan(th_raw)) ||
                        (k + 1 < n && isnan(p1_raw) && !isnan(th1_raw));
        }
      }
      th_raw = th1_raw;
      th_k = th_k1;
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float r = acc_ph[v] + (te - acc_th) * acc_s[v];
      if (nan_sel[v]) r = nan;
      if (t < th_min) r = lo_ph[v];
      if (t >= th_max) r = hi_ph[v];
      if (mask_edges && (t < th_min || t > th_max)) r = nan;
      oc[v][j * o_ms] = xt::from_compute<PH>(r);
    }
  }
}

template <int NV, typename TH, typename PH>
void launch(const void* th, const xt::VarSet<PH>& vars, const float* tg, long long cols,
            long long n, long long m, long long th_cs, long long th_ks, long long t_cs,
            long long t_ms, long long o_cs, long long o_ms, int mask_edges, int check_flip,
            cudaStream_t stream) {
  const int threads = 128;
  interp_linear_kernel<NV, TH, PH><<<xt::blocks_for(cols, threads), threads, 0, stream>>>(
      static_cast<const TH*>(th), vars, tg, cols, n, m, th_cs, th_ks, t_cs, t_ms, o_cs, o_ms,
      mask_edges, check_flip);
}

template <typename TH, typename PH>
int dispatch(int nv, const void* th, const void* const* phs, const long long* ph_cs,
             const long long* ph_ks, void* const* outs, const float* tg, long long cols,
             long long n, long long m, long long th_cs, long long th_ks, long long t_cs,
             long long t_ms, long long o_cs, long long o_ms, int mask_edges, int check_flip,
             cudaStream_t s) {
  const xt::VarSet<PH> vars = xt::make_varset<PH>(nv, phs, ph_cs, ph_ks, outs);
#define XT_ARGS th, vars, tg, cols, n, m, th_cs, th_ks, t_cs, t_ms, o_cs, o_ms, mask_edges, \
                check_flip, s
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

int run(int nv, const void* th, const void* const* phs, const long long* ph_cs,
        const long long* ph_ks, void* const* outs, const void* tg, int th_dtype, int ph_dtype,
        long long cols, long long n, long long m, long long th_cs, long long th_ks,
        long long t_cs, long long t_ms, long long o_cs, long long o_ms, int mask_edges,
        int check_flip, void* stream) {
  if (cols == 0 || m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(tg);
#define XT_ARGS nv, th, phs, ph_cs, ph_ks, outs, t, cols, n, m, th_cs, th_ks, t_cs, t_ms, o_cs, \
                o_ms, mask_edges, check_flip, s
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

}  // namespace

// Kernel C: one variable.
extern "C" int xt_interp_linear(const void* th, const void* ph, const void* tg, void* out,
                                int th_dtype, int ph_dtype, long long cols, long long n,
                                long long m, long long th_cs, long long th_ks,
                                long long ph_cs, long long ph_ks, long long t_cs,
                                long long t_ms, long long o_cs, long long o_ms,
                                int mask_edges, int check_flip, void* stream) {
  return run(1, th, &ph, &ph_cs, &ph_ks, &out, tg, th_dtype, ph_dtype, cols, n, m, th_cs,
             th_ks, t_cs, t_ms, o_cs, o_ms, mask_edges, check_flip, stream);
}

// Kernel F: 2 <= nv <= 8 variables sharing theta and the targets.  phs,
// ph_cs, ph_ks and outs are host arrays of nv entries; every phi shares
// ph_dtype; every output is (cols, m) in that dtype with strides
// (o_cs, o_ms).
extern "C" int xt_interp_linear_multi(const void* th, const void* const* phs,
                                      const long long* ph_cs, const long long* ph_ks,
                                      void* const* outs, const void* tg, int nv, int th_dtype,
                                      int ph_dtype, long long cols, long long n, long long m,
                                      long long th_cs, long long th_ks, long long t_cs,
                                      long long t_ms, long long o_cs, long long o_ms,
                                      int mask_edges, int check_flip, void* stream) {
  return run(nv, th, phs, ph_cs, ph_ks, outs, tg, th_dtype, ph_dtype, cols, n, m, th_cs, th_ks,
             t_cs, t_ms, o_cs, o_ms, mask_edges, check_flip, stream);
}
