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
// column every matching interval contributes, as in the plain version's
// membership sums (_fused_multi_ref_torch), so the kernel agrees with it
// everywhere; F computes each variable with C's code, so on every column it
// gives what V calls of C give, bit for bit (the TPU multi kernel's
// last-writer-wins select is not carried over).
//
// Bound on the card: memory.  Each call must move ((1 + V) n + V m) * cols
// * itemsize bytes when theta, the V phis and the outputs are all distinct;
// a phi broadcast along the column (knot stride 0, the step's kinetic
// energy) reads one value per column, so the step's remap moves
// (n + 1 + m) * cols * 4 bytes.  About 0.4 operations per byte at V = 4,
// against the card's ~20 for float32 outside the tensor cores; the tensor
// cores have no role (there is no product).  What holds it from that bound
// is the latency of each block's dependent steps (a block's items each wait
// on about ten loads and a division in turn), which the blocks an SM hide
// only in part: the prepass on one thread a column took 29-40 % of a
// block's time before it was spread over the column's threads (step 2).
//
// Design.  A block of 128 threads takes a tile of TC consecutive columns
// (TC = 64, halved while the tile would pass kTileBudget bytes: at n = 90
// TC = 64 for C, 32 for F at V = 2..3, 16 at V = 4..7, 8 at V = 8; down to
// 1 for very deep columns).  Small blocks, eight or nine to an SM, keep the
// staging, the prepass and the items of different blocks overlapping.
//   1. Staging.  theta and each phi of the tile go to shared memory as
//      float (16-bit inputs widen here) by cp.async, so all of a block's
//      copies are in flight at once.  A contiguous tile (the row-major
//      (cols, n) layout, one run of TC * n values) goes in 16-byte copies
//      into rows of n words; any other layout goes element by element into
//      rows of n | 1 words, consecutive threads on consecutive elements along
//      the smaller of the column and knot strides, so the lanes-major
//      (n, cols) layout and strided views load coalesced too.  A phi with
//      knot stride 0 loads one value per column.  Addresses are a 64-bit
//      base per tile plus offsets stepped without division; after the
//      staging everything indexes shared memory with 32-bit ints.
//   2. Prepass, g = 128 / TC threads a column (at most 32, so a column's
//      threads share a warp: 2 for C, 8 for F at V = 4 and n = 90; all 128
//      threads take part down to TC = 4): the first and last valid knot, the
//      valid range [th_min, th_max], the direction, and whether the column
//      is sorted: every knot from the first to the last valid one is valid
//      and theta_eff = theta * dsign does not decrease.  Each thread scans a
//      run of about n / g knots without a branch: how many are valid, the
//      first and last valid one, and whether a knot lies below or above the
//      one before it (NaN compares false, so a NaN end fails neither); the
//      group joins its runs by __shfl_xor_sync in log2 g steps.  Adjacent
//      knots are the neighbours compared where no NaN lies inside the valid
//      range (the count of valid knots shows one), so this is what one pass
//      over the valid knots gives.  The direction compares the end knots as
//      nan_to_num would leave them (infinities clamp to FLT_MAX).  A sorted
//      column's valid range is its end knots; any other gets a pass of
//      min/max (only the sign of a zero bound can differ from one pass, and
//      the bounds are only compared).  Each thread negates its own run of a
//      descending row in place, so rows hold theta_eff, NaN kept.
//   3. Work items.  Each thread takes (column, target) items, numbered along
//      the output's smaller stride (target-fastest for (cols, m) outputs,
//      column-fastest for the out_T (m, cols) layout), so consecutive threads
//      write consecutive addresses; per-column targets are read with the same
//      mapping.  A target that a clamp or the edge mask decides needs no
//      interval.  On a sorted column at most one interval matches, so a
//      binary search over [first, last] for the last knot with
//      theta_eff <= t_eff finds it (~7 steps at n = 90 instead of 90
//      compares); theta_eff[first], which decides whether a target needs
//      it, is an end of the valid range in the metadata.  A walk along each
//      column's sorted knots and shared targets, in place of the search, was
//      measured slower at these shapes (the search's loads overlap across
//      items; the walk's are a chain).  The search's boundary cases, each
//      giving what the full scan gives:
//        - t_eff NaN or +inf: no interval matches (the scan's
//          !(theta_eff[k+1] <= t_eff) fails for every k), r = fma(t_eff, 0,
//          0) = NaN, then the clamps decide;
//        - t_eff below theta_eff[first]: no interval matches;
//        - NaN heads (k < first) never match; NaN tails (k > last) are +inf,
//          so the search never reaches them, and the interval at last ends
//          on a +inf knot (slope 0, as in the scan);
//        - duplicate knots and a target exactly on a knot: the last knot
//          with theta_eff <= t_eff is the scan's only match;
//        - t_eff = -inf on a column whose first valid knot is -inf: the
//          last -inf knot matches, as in the scan, and gives NaN.
//      The result is fma(t_eff - theta_k, slope, phi_k) with an explicit
//      __fmaf_rn, as the scan's one-term sums give it (only the sign of a
//      zero can differ).  A column that is not sorted (non-monotone, or a
//      NaN knot inside the valid range) keeps the full scan over its row in
//      shared memory, every matching interval summed in knot order.
//   4. F shares the search: the interval and the theta terms are found once
//      per item, then a loop over the V phi tiles (all staged in step 1)
//      computes and stores each variable with C's code (value()), so F's
//      registers do not grow with V and F equals V calls of C bit for bit.
// Shared memory per block: TC * (16 + 4 r (1 + V') + 4 V'') bytes, r = n or
// n | 1, V' phis staged in full and V'' broadcast (C on the step: 24,576
// bytes at TC = 64 and n = 90, nine blocks an SM; F at V = 4 and n = 90:
// 29,376 bytes at TC = 16, seven blocks, as the shared memory allows).
// Registers (-Xptxas -v, the build line of chip_smoke.py): 54-64 per thread
// over the 32 instantiations, capped by __launch_bounds__ so that nine blocks
// fit an SM for C (54-56, no spills) and eight for F (64; the cap costs F at
// V >= 3 a few spill stores, 464 bytes over the whole library).
// Limit: a block must hold at least one column, so n is bounded by about
// 227 KB / (4 (1 + V)) (28,000 knots for C, 6,300 for F at V = 8); deeper
// columns get cudaErrorInvalidValue, and the wrapper raises.
#include <math.h>

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTile = 64;             // columns a block takes at most
constexpr int kMaxGroup = 32;            // threads a column's prepass takes at most
constexpr int kTileBudget = 48 * 1024;   // shared bytes a tile aims to stay under
constexpr int kMaxShared = 227 * 1024;   // what one block may have on the H100

// Per column: the first valid knot (< 0: all NaN); the last valid knot with
// the direction and sortedness flags above it; the valid range.
constexpr int kDesc = 1 << 30, kSorted = 1 << 29, kIndex = kSorted - 1;
struct alignas(16) ColMeta {
  int first, info;
  float th_min, th_max;
};

// The full scan of a column that is not sorted: every interval with
// theta_eff[k] <= te < theta_eff[k+1] adds its terms, in knot order, as the
// plain version's membership sums do.
__device__ float scan_row(const float* row, const float* ph, int pks, int n, float te) {
  float acc_th = 0.0f, acc_ph = 0.0f, acc_s = 0.0f;
  bool nan_sel = false;
  for (int k = 0; k < n; ++k) {
    const float s = row[k], s1 = (k + 1 < n) ? row[k + 1] : NAN;
    const float e = fminf(s, INFINITY), e1 = fminf(s1, INFINITY);  // NaN -> +inf
    if (!(e <= te) || e1 <= te) continue;
    const float dth = e1 - e;
    const float p_raw = ph[k * pks];
    const float p1_raw = (k + 1 < n) ? ph[(k + 1) * pks] : 0.0f;
    const float p = isnan(p_raw) ? 0.0f : p_raw;
    const float p1 = isnan(p1_raw) ? 0.0f : p1_raw;
    acc_th += e;
    acc_ph += p;
    acc_s += (dth > 0.0f && dth < INFINITY) ? (p1 - p) / dth : 0.0f;
    // NaN data at a valid knot (k or k+1) propagates into this interval
    nan_sel |= (isnan(p_raw) && !isnan(s)) || (isnan(p1_raw) && !isnan(s1));
  }
  return nan_sel ? NAN : __fmaf_rn(te - acc_th, acc_s, acc_ph);
}

// On a sorted column (no NaN in [lo, last]), the last knot in [lo, last]
// with theta_eff <= te, given theta_eff[lo] <= te.
__device__ __forceinline__ int search(const float* row, int lo, int last, float te) {
  int len = last - lo + 1;
  while (len > 1) {
    const int half = len >> 1;
    if (row[lo + half] <= te) lo += half;
    len -= half;
  }
  return lo;
}

// A run of knots of one column row: its first and last valid knot (first =
// n, last = -1: none), how many are valid, and fails: bit 0 set where a knot
// lies below the knot before it, bit 1 where one lies above it (a NaN
// compares false, so it fails neither).
struct Span {
  int first, last, valid, fails;
};

__device__ __forceinline__ Span scan_span(const float* row, int k0, int k1, int n) {
  Span s{n, -1, 0, 0};
  if (k0 >= k1) return s;
  float prev = k0 > 0 ? row[k0 - 1] : NAN;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float v = row[k];
    const bool ok = !isnan(v);
    s.valid += ok;
    s.first = ok ? min(s.first, k) : s.first;
    s.last = ok ? k : s.last;
    s.fails |= (int)(v < prev) | (int)(v > prev) << 1;
    prev = v;
  }
  return s;
}

// The least and greatest valid knot of a run (a column that is not sorted).
__device__ __forceinline__ void scan_range(const float* row, int k0, int k1, float& mn,
                                           float& mx) {
  for (int k = k0; k < k1; ++k) {
    const float v = row[k];
    if (isnan(v)) continue;
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
}

// The prepass of a tile (step 2), g threads a column: the column's
// metadata into meta[c], and a descending row negated in place, so the row
// then holds theta_eff with NaN kept.  Every thread of the block calls it.
__device__ __forceinline__ void prepare_tile(float* th_s, int rs, ColMeta* meta, int tc, int n,
                                             int g, int check_flip) {
  constexpr unsigned kAll = 0xffffffffu;
  const int c = threadIdx.x / g, h = threadIdx.x - c * g;
  const bool active = c < tc;
  float* row = th_s + c * rs;
  const int kn = (n + g - 1) / g;
  const int k0 = min(n, h * kn), k1 = active ? min(n, k0 + kn) : k0;
  Span s = scan_span(row, k0, k1, n);
  for (int d = 1; d < g; d <<= 1) {  // the group's lanes differ in the bits below g
    s.first = min(s.first, __shfl_xor_sync(kAll, s.first, d));
    s.last = max(s.last, __shfl_xor_sync(kAll, s.last, d));
    s.valid += __shfl_xor_sync(kAll, s.valid, d);
    s.fails |= __shfl_xor_sync(kAll, s.fails, d);
  }
  const bool any = active && s.valid > 0;
  const int first = any ? s.first : -1, last = any ? s.last : -1;
  // the valid knots are those of [first, last] and the valid neighbours
  // the ones compared, as in one pass over the valid knots, if no NaN lies
  // between them
  const bool gap = s.valid != last - first + 1;
  const float fv = any ? row[first] : 0.0f, lv = any ? row[last] : 0.0f;
  bool desc = false;
  if (any && check_flip) {
    // compared as nan_to_num would leave them (infinities clamp to FLT_MAX)
    const float f = fminf(fmaxf(fv, -FLT_MAX), FLT_MAX);
    const float l = fminf(fmaxf(lv, -FLT_MAX), FLT_MAX);
    desc = l < f;
  }
  const bool sorted = any && !gap && !(s.fails & (desc ? 2 : 1));
  // the valid range: the end knots of a sorted column, else a pass of min/max
  float mn = sorted ? (desc ? lv : fv) : INFINITY, mx = sorted ? (desc ? fv : lv) : -INFINITY;
  if (__any_sync(kAll, any && !sorted)) {
    if (any && !sorted) scan_range(row, k0, k1, mn, mx);
    for (int d = 1; d < g; d <<= 1) {
      mn = fminf(mn, __shfl_xor_sync(kAll, mn, d));
      mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, d));
    }
  }
  if (desc)
    for (int k = max(k0, first); k < min(k1, last + 1); ++k) row[k] = -row[k];
  if (active && h == 0)
    meta[c] = ColMeta{first, (any ? last : 0) | (desc ? kDesc : 0) | (sorted ? kSorted : 0),
                      mn, mx};
}

// A target against a column: its effective value and which clamp, if any,
// decides its result.
struct Where {
  float te;
  bool below, above, masked, interior;
};

__device__ __forceinline__ Where where(const ColMeta& cm, float t, int mask_edges) {
  Where w;
  w.te = (cm.info & kDesc) ? -t : t;
  w.below = t < cm.th_min;
  w.above = t >= cm.th_max;
  w.masked = mask_edges && (w.below || t > cm.th_max);
  w.interior = !(w.below || w.above || w.masked);
  return w;
}

// Whether a target needs the interval of a sorted column; then
// theta_eff[first] <= te < +inf.  On a sorted column theta_eff[first] is an
// end of the valid range: th_min, or -th_max where the column descends.
__device__ __forceinline__ bool searched(const ColMeta& cm, const Where& w) {
  const float e_first = (cm.info & kDesc) ? -cm.th_max : cm.th_min;
  return w.interior && (cm.info & kSorted) && w.te < INFINITY && e_first <= w.te;
}

// The theta side of interval k of a sorted column (k < 0: none matches),
// shared by the variables.
struct Side {
  int k;
  bool nxt, ok;
  float e0, dth;
};

__device__ __forceinline__ Side side(const float* row, int k, int last) {
  Side sd;
  sd.k = k;
  sd.nxt = k >= 0 && k < last;
  sd.e0 = k >= 0 ? row[k] : 0.0f;
  sd.dth = k >= 0 ? (sd.nxt ? row[k + 1] : INFINITY) - sd.e0 : 0.0f;
  sd.ok = sd.dth > 0.0f && sd.dth < INFINITY;
  return sd;
}

// The result of one variable (phi row ph, knot stride pks) at one target.
// C and F compute it with this code, so F equals V calls of C bit for bit.
__device__ __forceinline__ float value(const float* row, const float* ph, int pks, int n,
                                       const ColMeta& cm, const Where& w, const Side& sd) {
  const int first = cm.first, last = cm.info & kIndex;
  const bool desc = cm.info & kDesc;
  float r = 0.0f;
  if (w.interior && !(cm.info & kSorted)) {
    r = scan_row(row, ph, pks, n, w.te);
  } else if (w.interior) {
    float p0 = 0.0f, s = 0.0f;
    bool bad = false;
    if (sd.k >= 0) {
      const float p_raw = ph[sd.k * pks];
      const float p1_raw = sd.nxt ? ph[(sd.k + 1) * pks] : 0.0f;
      p0 = isnan(p_raw) ? 0.0f : p_raw;
      const float p1 = isnan(p1_raw) ? 0.0f : p1_raw;
      s = sd.ok ? (p1 - p0) / sd.dth : 0.0f;
      // NaN data at a valid knot (k or k+1) propagates into the interval
      bad = isnan(p_raw) || isnan(p1_raw);
    }
    r = bad ? NAN : __fmaf_rn(w.te - sd.e0, s, p0);
  }
  if (w.below) r = ph[(desc ? last : first) * pks];
  if (w.above) r = ph[(desc ? first : last) * pks];
  if (w.masked) r = NAN;
  return r;
}

// Nine blocks of C on the step fit an SM's shared memory (24,576 bytes each)
// and, at 56 registers, its register file; F's tiles allow seven or eight.
template <int NV, typename TH, typename PH>
__global__ void __launch_bounds__(kThreads, NV == 1 ? 9 : 8) interp_linear_kernel(
    const TH* __restrict__ th, const xt::VarSet<PH> vars, const float* __restrict__ tg,
    long long cols, int n, int m, int tile, long long th_cs, long long th_ks, long long t_cs,
    long long t_ms, long long o_cs, long long o_ms, int mask_edges, int check_flip) {
  extern __shared__ float smem[];
  const long long c0 = (long long)blockIdx.x * tile;
  const int tc = (int)min((long long)tile, cols - c0);
  // rows as in a contiguous theta (16-byte copies), else of an odd length
  const int rs = (th_ks == 1 && th_cs == n) ? n : (n | 1);
  ColMeta* meta = reinterpret_cast<ColMeta*>(smem);
  float* th_s = smem + tile * (int)(sizeof(ColMeta) / sizeof(float));
  float* ph_base = th_s + tile * rs;

  // 1. stage theta and the phis
  xt::load_tile(th + c0 * th_cs, th_cs, th_ks, tc, n, th_s, rs);
  {
    float* p = ph_base;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const bool bc = vars.ks[v] == 0;
      xt::load_tile(vars.in[v] + c0 * vars.cs[v], vars.cs[v], vars.ks[v], tc, bc ? 1 : n, p,
                bc ? 1 : rs);
      p += bc ? tile : tile * rs;
    }
  }
  xt::wait_copies();
  __syncthreads();

  // 2. the prepass, g threads a column
  prepare_tile(th_s, rs, meta, tc, n, min(kThreads / tile, kMaxGroup), check_flip);
  __syncthreads();

  // 3. (column, target) items numbered along the output's smaller stride
  const bool tgt_fast = llabs(o_ms) <= llabs(o_cs);
  const int inner = tgt_fast ? m : tc;
  const int step_a = blockDim.x / inner, step_b = blockDim.x - step_a * inner;
  int a = threadIdx.x / inner, b = threadIdx.x - a * inner;
  for (int e = threadIdx.x; e < tc * m; e += blockDim.x) {
    const int c = tgt_fast ? a : b, j = tgt_fast ? b : a;
    a += step_a;
    b += step_b;
    if (b >= inner) {
      b -= inner;
      ++a;
    }
    const long long gc = c0 + c;
    const long long o = gc * o_cs + j * o_ms;
    const ColMeta cm = meta[c];
    if (cm.first < 0) {  // all-NaN column
#pragma unroll
      for (int v = 0; v < NV; ++v) vars.out[v][o] = xt::from_compute<PH>(NAN);
      continue;
    }
    const float* row = th_s + c * rs;
    const int last = cm.info & kIndex;
    const Where w = where(cm, tg[gc * t_cs + j * t_ms], mask_edges);
    // 4. the one interval of a sorted column, shared by the variables
    const int k = searched(cm, w) ? search(row, cm.first, last, w.te) : -1;
    const Side sd = side(row, k, last);
    const float* p = ph_base;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const bool bc = vars.ks[v] == 0;
      vars.out[v][o] =
          xt::from_compute<PH>(value(row, p + (bc ? c : c * rs), bc ? 0 : 1, n, cm, w, sd));
      p += bc ? tile : tile * rs;
    }
  }
}

template <int NV, typename TH, typename PH>
int launch(const void* th, const xt::VarSet<PH>& vars, const float* tg, long long cols,
           long long n, long long m, long long th_cs, long long th_ks, long long t_cs,
           long long t_ms, long long o_cs, long long o_ms, int mask_edges, int check_flip,
           cudaStream_t stream) {
  if (n > (1 << 24) || m > (1 << 24)) return (int)cudaErrorInvalidValue;
  const TH* theta = static_cast<const TH*>(th);
  const size_t rs = (size_t)(n | 1);
  int broadcast = 0;
  for (int v = 0; v < NV; ++v) broadcast += vars.ks[v] == 0;
  // column metadata, theta and the phis of `tile` columns
  auto bytes_of = [&](int tile) {
    return (size_t)tile *
           (sizeof(ColMeta) + sizeof(float) * (rs * (1 + NV - broadcast) + broadcast));
  };
  int tile = kMaxTile;
  while (tile > 1 && bytes_of(tile) > (size_t)kTileBudget) tile /= 2;
  const size_t bytes = bytes_of(tile);
  if (bytes > (size_t)kMaxShared) return (int)cudaErrorInvalidValue;
  auto kernel = interp_linear_kernel<NV, TH, PH>;
  if (bytes > 48 * 1024) {  // dynamic shared memory above the default needs the attribute
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<xt::blocks_for(cols, tile), kThreads, bytes, stream>>>(
      theta, vars, tg, cols, (int)n, (int)m, tile, th_cs, th_ks, t_cs, t_ms, o_cs, o_ms,
      mask_edges, check_flip);
  return 0;
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
    case 1: return launch<1, TH, PH>(XT_ARGS);
    case 2: return launch<2, TH, PH>(XT_ARGS);
    case 3: return launch<3, TH, PH>(XT_ARGS);
    case 4: return launch<4, TH, PH>(XT_ARGS);
    case 5: return launch<5, TH, PH>(XT_ARGS);
    case 6: return launch<6, TH, PH>(XT_ARGS);
    case 7: return launch<7, TH, PH>(XT_ARGS);
    case 8: return launch<8, TH, PH>(XT_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef XT_ARGS
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
