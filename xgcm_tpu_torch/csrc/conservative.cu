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
// untouched-bin -> NaN rule (the plain versions _conservative_plain and
// _conservative_multi_plain in ops/kernels/conservative.py):
//   * a cell k spans the raw bounds theta[k], theta[k+1]; a cell with both
//     bounds NaN is empty, a cell with one NaN bound is degenerate at the
//     other;
//   * bin j = [e_j, e_{j+1}] receives w_k * (frac_k(e_{j+1}) - frac_k(e_j)),
//     frac_k(x) = clip((x - tmin_k) * inv_k, 0, 1) with inv_k = 1 / thick_k,
//     w_k the datum with +-inf as +-FLT_MAX (nan_to_num); the clip lets NaN
//     through, as jnp.clip does;
//   * a degenerate cell (thick == 0) steps instead: (e_{j+1} >= tmin) at the
//     upper edge and (e_j > tmin) at the lower, so a cell exactly on an
//     interior edge counts into both bins;
//   * a bin no valid cell overlaps (tmin <= e_{j+1} and tmax >= e_j) is NaN;
//   * G leaves a cell whose datum is NaN out whole.  H takes the geometry
//     from the bounds alone and enters such a cell as 0 * (frac difference),
//     as _conservative_multi_kernel does, so where that difference is NaN
//     (an infinite bound) H's bin is NaN and G's is not.
// The TPU kernel's sentinels (invalid cells parked at 1e38, degenerate cells
// folded into the mass term with a 3e38 slope) exist because the TPU has no
// cheap per-lane branch; here the twin's own branches run instead.
//
// Bound on the card: memory.  Each call must move ((n + 1) + V n + V (m - 1))
// * cols * itemsize bytes (bounds, fields, outputs; m edges).  A merge of the
// sorted bounds and edges visits about n + m (cell, bin) overlaps per column,
// some 8 operations each per variable: 0.6 operations per byte, against the
// card's ~20 for float32 outside the tensor cores.  Tensor cores, TMA and
// clusters have no role: there is no product, and a tile is a few KB.
//
// Design (that of kernels C and F in interp_linear.cu).  A block of 128
// threads takes a tile of TC consecutive columns (TC = 64, halved while the
// tile would pass kTileBudget = 30 KB, so that seven or eight blocks share
// an SM's 228 KB: at n = 90 TC = 32 for G, 16 for H at V = 2..4, 8 at
// V = 5..8, and about half that with reassociate; down to 1 for very deep
// columns).  H at V = 4 then runs 560 (column, bin) items a block on 128
// threads (TC = 8 would leave the last of three rounds a fifth full).
//   1. Staging.  The bounds and each field of the tile go to shared memory as
//      float by cp.async (xt::load_tile: 16-byte copies for a contiguous
//      tile into unpadded rows, element-wise along the smaller stride into
//      rows of odd length otherwise).  The block checks that the edges are
//      finite (|e| <= 2^126) and non-decreasing; items read them through
//      the read-only cache.
//   2. Prepass, g threads a column: g = 128 / TC', TC' the block's columns
//      rounded up to a power of two, at most 32 so that a column's threads
//      share a warp (at n = 90: 4 for G, 8 for H at V = 2..4; 32 for a
//      block of up to four columns).  It finds the first and last valid
//      bound f, l, the direction (descending when theta[l] < theta[f]), and
//      whether the column may be walked: every bound from f to l valid,
//      monotone in its direction, and within |theta| <= 2^126.  Each thread
//      scans a run of about (n + 1) / g bounds without a branch: how many
//      are valid, the first and last valid one, whether a bound lies below
//      or above the one before it (NaN compares false, so a NaN neighbour
//      sets neither), and whether one lies beyond 2^126; the group joins its
//      runs by __shfl_xor_sync in log2 g steps.  Where the valid bounds fill
//      [f, l], no NaN lies inside and the neighbours compared are the ones a
//      pass over the valid bounds compares, so the metadata are those of
//      one pass over the row.  With reassociate the block then builds, per
//      walkable column and variable, the prefix P[k] = sum of the weights of
//      the valid cells below k, each on one thread in ascending k.
//   3. Work items.  Each thread takes (column, bin) items numbered along the
//      output's smaller stride (bin-fastest for (cols, m - 1) outputs,
//      column-fastest for the out_T (m - 1, cols) layout), so consecutive
//      threads store consecutive addresses.  On a walkable column the cells
//      that can deposit into bin [lo, hi] form one run of k.  In effective
//      space (theta * s, s = -1 on a descending column; lo_e, hi_e the bin
//      in that space, swapped and negated when s = -1) a binary search finds
//      S = the first bound in [f, l] with s theta >= lo_e; the walk starts at
//      k0 = max(S - 1, 0) (S >= f, so the head cell f - 1 is in reach) and
//      stops at the first k with s theta[k] > hi_e (the NaN bounds below f
//      never stop it), or after k = min(l, n - 1).  About six search steps
//      and two to four cells replace the 50 cells of a full pass.  A column
//      that is not walkable (a NaN bound inside, not monotone, a huge or
//      infinite bound, or bad edges) keeps the full pass over its n cells.
//      Both run one per-cell function (cell_terms, deposit) in ascending k
//      with an explicit __fmaf_rn, and the walk-or-scan choice reads the
//      bounds and edges only, so H equals V calls of G bit for bit wherever
//      the fractions are finite.  H shares the search and each cell's
//      geometry across its variables.
//   4. reassociate: F(e) = sum_k w_k frac_k(e) is summed at the bin's two
//      edges, F(hi) - F(lo) taken once.  The walk adds the cells it skips
//      below the bin from the prefix: P[k0] on an ascending column, P[n] -
//      P[k_end] on a descending one (they deposit frac = 1 at both edges).
//
// Why the walk gives what the plain version's sum over all cells gives.
// Visiting a cell the plain version sums is never wrong; each skipped cell
// must contribute nothing (or, below, as good as nothing), and every
// overlapping cell must be visited so that the count (the NaN footprint)
// agrees.  Ascending column (tmin = theta[k], tmax = theta[k+1] inside
// [f, l]); the descending case is the same in effective space, where the
// skipped head holds cells above the bin and the skipped tail cells below.
//   - Skipped above the bin (k past the stop, tmin > hi): (x - tmin) * inv
//     is negative or -0 at both edges, so frac = 0 at both: the term is 0.
//   - Skipped below the bin (k < S - 1, tmax < lo): (lo - tmin) rounds to no
//     less than thick, and inv = RN(1 / thick), so frac(lo) >= 1 - 2^-24 and
//     the term is at most |w| 2^-24.  The plain version deposits that into
//     the bin; the walk does not.  Over the skipped cells that is at most
//     2^-24 sum|phi| per bin, inside the tolerance n 2^-24 sum|phi|
//     (PERF.md section 2), and it moves no count.
//   - Touching: a cell with tmax == lo or tmin == hi overlaps by the count's
//     inclusive test, deposits (1 - 1) or (0 - 0) = 0, and is visited: S is
//     the first bound >= lo, and the walk stops only at a bound > hi.
//   - Degenerate end cells.  The cell f - 1 (a NaN head) is degenerate at
//     theta[f]; it is visited exactly when S <= f, i.e. theta[f] >= lo (in
//     effective space), and its step terms are 0 when it is skipped (below:
//     1 - 1; on a descending column, above: 0 - 0).  The cell l (a NaN tail)
//     is degenerate at theta[l]; the walk reaches it exactly when theta[l]
//     passes the stop test, and when it does not its step terms are 0 - 0
//     (ascending, above) or 1 - 1 (descending, below).  A visited end cell
//     that does not overlap adds 0 and no count.
//   - A degenerate cell exactly on an interior edge e_j: for bin j - 1 it
//     has tmin == hi (not past the stop), for bin j tmax == lo (not before
//     S): both bins visit it and receive its full mass, as the plain
//     version's steps give.
//   - Descending columns: the run of k lies reversed against theta; it is
//     summed in ascending k all the same.
//   - Infinite bounds.  -inf as tmin makes (x - tmin) * 0 = NaN, and [inf,
//     inf] or [-inf, -inf] makes thick NaN: frac is NaN at every edge, so
//     every bin of the column is NaN, not only the overlapped ones.  +inf as
//     tmax gives inv = 0 and frac = 0.  Any bound beyond 2^126 (or edges
//     beyond it) sends the column to the full pass, where every cell meets
//     every edge as in the plain version; below 2^126 no difference of a
//     bound and an edge overflows and no thickness is infinite, so frac is
//     NaN only where x == tmin on a cell of denormal thickness (inv = inf),
//     a cell both bins of that edge visit.
//
// Shared memory per block: 16 TC + 4 (r4(TC r_t) + V r4(TC r_p)) bytes
// (+ 4 V r4(TC (n + 1)) with reassociate), r_t = n + 1 or (n + 1) | 1,
// r_p = n or n | 1, r4 rounding up to 4 floats (at n = 90: G 23,680 bytes
// at TC = 32; H at V = 4 29,120 bytes at TC = 16).
// Limit: a block must hold one column, so n is bounded by about
// 227 KB / (4 (1 + V)) (29,000 cells for G, 6,400 for H at V = 8; half that
// with reassociate); deeper columns get cudaErrorInvalidValue, and the
// wrapper raises.
#include <math.h>

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTile = 64;             // columns a block takes at most
constexpr int kMaxGroup = 32;            // threads a column's prepass takes at most
constexpr int kTileBudget = 30 * 1024;   // shared bytes a tile aims to stay under: 7-8 blocks an SM
constexpr int kMaxShared = 227 * 1024;   // what one block may have on the H100
constexpr float kTame = 0x1p126f;        // bounds and edges the walk takes

// Per column: the first and last valid bound (first < 0: all NaN) and flags.
constexpr int kDesc = 1, kWalk = 2;
struct alignas(16) ColMeta {
  int first, last, info, pad;
};

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// clip(x, 0, 1) that lets NaN through, as jnp.clip and the plain version's
// maximum/minimum do (fmaxf/fminf would drop it).
__device__ __forceinline__ float clip01(float x) {
  return x > 0.0f ? fminf(x, 1.0f) : (isnan(x) ? x : 0.0f);
}

// A cell's fractions at a bin's edges and whether it overlaps the bin, from
// its raw bounds t1, t2 (not both NaN), as _geometry and _accumulate
// compute them.
struct Cell {
  float up, lo;
  bool overlap;
};

__device__ __forceinline__ Cell cell_terms(float t1, float t2, float lo, float hi) {
  // a single NaN bound makes the cell degenerate at the other: fminf and
  // fmaxf return the other operand then
  const float tmin = fminf(t1, t2), tmax = fmaxf(t1, t2);
  const float thick = tmax - tmin;
  Cell c;
  if (thick == 0.0f) {
    c.up = hi >= tmin ? 1.0f : 0.0f;
    c.lo = lo > tmin ? 1.0f : 0.0f;
  } else {
    const float inv = 1.0f / thick;
    c.up = clip01((hi - tmin) * inv);
    c.lo = clip01((lo - tmin) * inv);
  }
  c.overlap = (tmin <= hi) && !(tmax < lo);
  return c;
}

// A field value as a weight: +-inf as +-FLT_MAX (nan_to_num).
__device__ __forceinline__ float weight(float p) {
  return isinf(p) ? copysignf(FLT_MAX, p) : p;
}

// One cell's deposit into the NV accumulators of a bin: ph is the cell's
// value of variable 0, the others vs floats apart.  G and H both run this,
// so H equals V calls of G bit for bit where the fractions are finite.
template <int NV>
__device__ __forceinline__ void deposit(const Cell& c, const float* ph, int vs, int reassoc,
                                        float* up, float* dn, unsigned& hit) {
  const float d = c.up - c.lo;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float p = ph[v * vs];
    if (isnan(p)) {
      // G leaves the cell out; H adds 0 * d, NaN where d is
      if (NV > 1 && isnan(d)) up[v] = NAN;
      continue;
    }
    const float w = weight(p);
    if (reassoc) {
      up[v] = __fmaf_rn(w, c.up, up[v]);
      dn[v] = __fmaf_rn(w, c.lo, dn[v]);
    } else {
      up[v] = __fmaf_rn(w, d, up[v]);
    }
    if (c.overlap) hit |= 1u << v;
  }
}

// A run of bounds of one column row: its first and last valid bound (first
// = nk, last = -1: none), how many are valid, and flags: kBelow where a
// bound lies below the bound before it, kAbove where one lies above it (a
// NaN compares false, so it sets neither), kHuge where a bound lies beyond
// 2^126 (NaN is not).
constexpr int kBelow = 1, kAbove = 2, kHuge = 4;
struct Span {
  int first, last, valid, flags;
};

__device__ __forceinline__ Span scan_span(const float* row, int k0, int k1, int nk) {
  Span s{nk, -1, 0, 0};
  if (k0 >= k1) return s;
  float prev = k0 > 0 ? row[k0 - 1] : NAN;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float v = row[k];
    const bool ok = !isnan(v);
    s.valid += ok;
    s.first = ok ? min(s.first, k) : s.first;
    s.last = ok ? k : s.last;
    s.flags |= (int)(v < prev) | (int)(v > prev) << 1 | (int)(fabsf(v) > kTame) << 2;
    prev = v;
  }
  return s;
}

// The prepass of a tile (step 2), g threads a column: meta[c] from the
// column's nk bounds, as one pass over the row gives it.  Every thread of
// the block calls it.
__device__ __forceinline__ void prepare_tile(const float* th_s, int rs, ColMeta* meta, int tc,
                                             int nk, int g) {
  constexpr unsigned kAll = 0xffffffffu;
  const int c = threadIdx.x / g, h = threadIdx.x - c * g;
  const bool active = c < tc;
  const float* row = th_s + c * rs;
  const int kn = (nk + g - 1) / g;
  const int k0 = min(nk, h * kn), k1 = active ? min(nk, k0 + kn) : k0;
  Span s = scan_span(row, k0, k1, nk);
  for (int d = 1; d < g; d <<= 1) {  // the group's lanes differ in the bits below g
    s.first = min(s.first, __shfl_xor_sync(kAll, s.first, d));
    s.last = max(s.last, __shfl_xor_sync(kAll, s.last, d));
    s.valid += __shfl_xor_sync(kAll, s.valid, d);
    s.flags |= __shfl_xor_sync(kAll, s.flags, d);
  }
  if (!active || h != 0) return;
  ColMeta cm{-1, -1, 0, 0};
  if (s.valid > 0) {
    // every bound of [first, last] valid: no NaN inside, and the neighbours
    // compared are the valid ones a pass over the valid bounds compares
    const bool inside = s.valid == s.last - s.first + 1;
    const bool desc = row[s.last] < row[s.first];
    const bool mono = !(s.flags & (desc ? kAbove : kBelow));
    const bool walk = inside && mono && !(s.flags & kHuge);
    cm = ColMeta{s.first, s.last, (desc ? kDesc : 0) | (walk ? kWalk : 0), 0};
  }
  meta[c] = cm;
}

// The first bound i in [lo, hi] with s * row[i] >= x (hi + 1 if none), on a
// walkable column, where s * row does not decrease over [lo, hi]: one past
// the last bound below x.
__device__ __forceinline__ int first_at_least(const float* row, int lo, int hi, float s, float x) {
  if (!(s * row[lo] < x)) return lo;
  int len = hi - lo + 1;
  while (len > 1) {
    const int half = len >> 1;
    if (s * row[lo + half] < x) lo += half;
    len -= half;
  }
  return lo + 1;
}

template <int NV, typename TH, typename PH>
__global__ void __launch_bounds__(kThreads, 8) conservative_kernel(
    const TH* __restrict__ th, const xt::VarSet<PH> vars, const float* __restrict__ edges,
    long long cols, int n, int nb, int tile, int rs_t, int rs_p, long long th_cs,
    long long th_ks, long long o_cs, long long o_js, int reassoc) {
  extern __shared__ float smem[];
  const long long c0 = (long long)blockIdx.x * tile;
  const int tc = (int)min((long long)tile, cols - c0);
  ColMeta* meta = reinterpret_cast<ColMeta*>(smem);
  float* th_s = smem + 4 * tile;
  float* ph_s = th_s + round4(tile * rs_t);
  const int vs = round4(tile * rs_p);  // floats between the variables' tiles
  float* pre = ph_s + NV * vs;          // reassociate: the prefixes
  const int ps = round4(tile * (n + 1));

  // 1. stage the bounds and the fields; check the edges
  xt::load_tile(th + c0 * th_cs, th_cs, th_ks, tc, n + 1, th_s, rs_t);
#pragma unroll
  for (int v = 0; v < NV; ++v)
    xt::load_tile(vars.in[v] + c0 * vars.cs[v], vars.cs[v], vars.ks[v], tc, n, ph_s + v * vs,
                  rs_p);
  int bad = 0;
  for (int i = threadIdx.x; i <= nb; i += blockDim.x) {
    const float e = edges[i];
    bad |= !(fabsf(e) <= kTame) || (i > 0 && !(edges[i - 1] <= e));
  }
  xt::wait_copies();
  const bool edges_ok = !__syncthreads_or(bad);

  // 2. the prepass, g threads a column (g a power of two: the block's
  // columns, rounded up to one, share its threads, at most kMaxGroup each)
  int cols2 = 1;
  while (cols2 < tc) cols2 <<= 1;
  prepare_tile(th_s, rs_t, meta, tc, n + 1, min(kThreads / cols2, kMaxGroup));
  __syncthreads();
  if (reassoc) {
    // the prefixes of the walkable columns, each summed in ascending k
    for (int i = threadIdx.x; i < tc * NV; i += blockDim.x) {
      const int c = i % tc, v = i / tc;
      if (!(meta[c].info & kWalk)) continue;
      const float* row = th_s + c * rs_t;
      const float* ph = ph_s + v * vs + c * rs_p;
      float* p = pre + v * ps + c * (n + 1);
      float acc = 0.0f;
      p[0] = acc;
      for (int k = 0; k < n; ++k) {
        const float x = ph[k];
        if (!isnan(x) && !(isnan(row[k]) && isnan(row[k + 1]))) acc += weight(x);
        p[k + 1] = acc;
      }
    }
    __syncthreads();
  }

  // 3. (column, bin) items numbered along the output's smaller stride
  const bool bin_fast = llabs(o_js) <= llabs(o_cs);
  const int inner = bin_fast ? nb : tc;
  const int step_a = blockDim.x / inner, step_b = blockDim.x - step_a * inner;
  int a = threadIdx.x / inner, b = threadIdx.x - a * inner;
  for (int e = threadIdx.x; e < tc * nb; e += blockDim.x) {
    const int c = bin_fast ? a : b, j = bin_fast ? b : a;
    a += step_a;
    b += step_b;
    if (b >= inner) {
      b -= inner;
      ++a;
    }
    const long long o = (c0 + c) * o_cs + j * o_js;
    const ColMeta cm = meta[c];
    float up[NV], dn[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) up[v] = dn[v] = 0.0f;
    unsigned hit = 0;
    if (cm.first >= 0) {
      const float* row = th_s + c * rs_t;
      const float* ph = ph_s + c * rs_p;
      const float lo = __ldg(edges + j), hi = __ldg(edges + j + 1);
      const bool walk = edges_ok && (cm.info & kWalk);
      const float s = (cm.info & kDesc) ? -1.0f : 1.0f;
      const float hi_e = (cm.info & kDesc) ? -lo : hi;
      int k = 0, k_last = n - 1;
      if (walk) {
        const float lo_e = (cm.info & kDesc) ? -hi : lo;
        k = max(first_at_least(row, cm.first, cm.last, s, lo_e) - 1, 0);
        k_last = min(cm.last, n - 1);
      }
      const int k0 = k;
      for (; k <= k_last; ++k) {
        const float t1 = row[k], t2 = row[k + 1];
        if (walk && s * t1 > hi_e) break;  // the NaN bounds below f pass
        if (isnan(t1) && isnan(t2)) continue;
        deposit<NV>(cell_terms(t1, t2, lo, hi), ph + k, vs, reassoc, up, dn, hit);
      }
      if (walk && reassoc) {
        // the cells skipped below the bin, frac 1 at both edges
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float* p = pre + v * ps + c * (n + 1);
          const float below = (cm.info & kDesc) ? p[n] - p[min(k, n)] : p[k0];
          up[v] += below;
          dn[v] += below;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float r = reassoc ? up[v] - dn[v] : up[v];
      vars.out[v][o] = xt::from_compute<PH>(((hit >> v) & 1u) ? r : NAN);
    }
  }
}

template <int NV, typename TH, typename PH>
int launch(const void* th, const xt::VarSet<PH>& vars, const float* edges, long long cols,
           long long n, long long nb, long long th_cs, long long th_ks, long long o_cs,
           long long o_js, int reassoc, cudaStream_t stream) {
  if (n >= (1 << 24) || nb >= (1 << 24)) return (int)cudaErrorInvalidValue;
  // rows as in contiguous inputs (16-byte copies), else of an odd length
  const int rs_t = (th_ks == 1 && th_cs == n + 1) ? (int)n + 1 : (int)((n + 1) | 1);
  bool contiguous = true;
  for (int v = 0; v < NV; ++v) contiguous &= vars.ks[v] == 1 && vars.cs[v] == n;
  const int rs_p = contiguous ? (int)n : (int)(n | 1);
  // column metadata, bounds, fields and (reassociate) the prefixes
  auto bytes_of = [&](int tile) {
    size_t floats = 4 * (size_t)tile + round4(tile * rs_t) +
                    (size_t)NV * round4(tile * rs_p);
    if (reassoc) floats += (size_t)NV * round4(tile * ((int)n + 1));
    return floats * sizeof(float);
  };
  int tile = kMaxTile;
  while (tile > 1 && bytes_of(tile) > (size_t)kTileBudget) tile /= 2;
  const size_t bytes = bytes_of(tile);
  if (bytes > (size_t)kMaxShared) return (int)cudaErrorInvalidValue;
  auto kernel = conservative_kernel<NV, TH, PH>;
  if (bytes > 48 * 1024) {  // dynamic shared memory above the default needs the attribute
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<xt::blocks_for(cols, tile), kThreads, bytes, stream>>>(
      static_cast<const TH*>(th), vars, edges, cols, (int)n, (int)nb, tile, rs_t, rs_p, th_cs,
      th_ks, o_cs, o_js, reassoc);
  return 0;
}

template <typename TH, typename PH>
int dispatch(int nv, const void* th, const void* const* phs, const long long* ph_cs,
             const long long* ph_ks, void* const* outs, const float* edges, long long cols,
             long long n, long long nb, long long th_cs, long long th_ks, long long o_cs,
             long long o_js, int reassoc, cudaStream_t s) {
  const xt::VarSet<PH> vars = xt::make_varset<PH>(nv, phs, ph_cs, ph_ks, outs);
#define XT_ARGS th, vars, edges, cols, n, nb, th_cs, th_ks, o_cs, o_js, reassoc, s
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
