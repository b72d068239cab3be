// The weighted sum: the one pass of Grid.integrate on the card.
//
// Replaces no TPU kernel.  The JAX package's integrate is
// sum(nan_to_num(da * metric)), which XLA fuses on the TPU into one read of
// da.  Eager PyTorch makes four passes over a field instead: the metric's
// product of its factors, the weighting, nan_to_num and the sum, writing
// three fields and reading five.  This kernel is that fusion, written by
// hand: it reads x once and writes a few bytes a block.
//
// out[s] = sum over the trailing dims of nan_to_num(x * ((f0 * f1) * ...)),
// the segments s being the leading (kept) indices.  Each factor broadcasts
// against x in x's dim order; their product is taken in the order given,
// in float32 (that of Grid.get_metric, which follows frozenset iteration
// and so reaches here at run time), then multiplied by x, with NaN mapped
// to 0 and +-inf to +-FLT_MAX: every weighted value equals PyTorch's bit
// for bit.  Each thread sums its values in double; a block's partial sum
// is reduced in a fixed tree and stored; a second small kernel adds each
// segment's partials in a fixed order and rounds once to float.  No
// atomics, so a call repeats to the bit.
//
// Bound on the card: memory.  One read of x; the factors are small (a
// vector a dim) unless one spans the row and other dims as well.  Design:
//
// * x is viewed as rows of its last dim (nx values), and a segment's rows
//   are consecutive.  A block takes a chunk of a segment's rows and one
//   tile of the row: each thread owns the same vpt vectors (16 bytes; 4
//   values) of every row of the chunk, so its vpt loads of a row are in
//   flight together and its columns never change.
// * Factors take one of three forms: constant along the row (read once a
//   row, a broadcast load), along the row only (the tile of it staged in
//   shared memory once a block, each thread its own vectors), or along the
//   row and other dims (read with the row).
// * A group of up to kThreads rows first finds, one row a thread, each
//   factor's value or offset in the row (the row's index over the outer
//   dims takes a division a dim) and keeps them in shared memory, so the
//   loop over the elements holds no index and divides nothing.
// * nx not a multiple of 4, or a base that is not 16-byte aligned, takes
//   the same kernel with vectors of one value.
#include <cfloat>
#include <cuda_runtime.h>

namespace {

// kept equal to ops/kernels/weighted_sum.py
constexpr int kDims = 7;                 // x's dims, right-aligned
constexpr int kOuter = kDims - 1;        // dims above the row
constexpr int kMaxFactors = 4;
constexpr int kThreads = 256;
constexpr int kMaxVectors = 5;           // vectors a thread of a row
constexpr unsigned kFullMask = 0xffffffffu;

enum Form : int { ROW_CONSTANT = 0, ALONG_ROW = 1, STAGED = 2 };

struct Args {
  const float* x;
  const float* f[kMaxFactors];
  long long fs[kMaxFactors][kOuter];  // each factor's stride along each outer dim
  int form[kMaxFactors];
  int slot[kMaxFactors];              // a staged factor's place in shared memory
  int size[kOuter];                   // outer dims, right-aligned, the leading ones 1
  long long nx;                       // the row
  long long rows;                     // rows a segment
  long long chunk_rows;
  int chunks, tiles, vpt;
  double* partial;                    // a block's sum, at blockIdx.x
};

template <int VW>
struct alignas(4 * VW) Vec {
  float v[VW];
};

template <int VW>
__device__ __forceinline__ Vec<VW> load(const float* p) {
  return *reinterpret_cast<const Vec<VW>*>(p);
}

// torch.nan_to_num(w, nan=0.0): +-inf to the largest finite float
__device__ __forceinline__ float nan_to_num(float w) {
  if (w != w) return 0.0f;
  if (fabsf(w) > FLT_MAX) return w > 0.0f ? FLT_MAX : -FLT_MAX;
  return w;
}

template <int VW, int NF>
__global__ void __launch_bounds__(kThreads, 4) weighted_sum_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Vec<VW>* staged = reinterpret_cast<Vec<VW>*>(smem);
  // per row of a group of kThreads rows: a factor's value (constant along
  // the row) or offset (along the row and other dims)
  __shared__ float row_value[NF][kThreads];
  __shared__ long long row_offset[NF][kThreads];
  __shared__ double warp_sums[kThreads / 32];

  const int tid = threadIdx.x;
  const long long block = blockIdx.x;
  const int tile = (int)(block % a.tiles);
  const long long rest = block / a.tiles;
  const long long chunk = rest % a.chunks;
  const long long seg = rest / a.chunks;
  const long long r0 = chunk * a.chunk_rows;
  const long long nrows = min(a.chunk_rows, a.rows - r0);
  const long long first = seg * a.rows + r0;  // the chunk's first row of x
  const long long nv = a.nx / VW;
  // the thread's first vector of a row; its j-th lies kThreads * j after
  const long long col0 = (long long)tile * kThreads * a.vpt + tid;
  unsigned valid = 0;
#pragma unroll
  for (int j = 0; j < kMaxVectors; ++j) {
    if (j < a.vpt && col0 + (long long)j * kThreads < nv) valid |= 1u << j;
  }
#pragma unroll
  for (int k = 0; k < NF; ++k) {
    if (a.form[k] != STAGED) continue;
#pragma unroll
    for (int j = 0; j < kMaxVectors; ++j) {
      if (valid >> j & 1u) {
        staged[(a.slot[k] * a.vpt + j) * kThreads + tid] =
            load<VW>(a.f[k] + (col0 + (long long)j * kThreads) * VW);
      }
    }
  }
  // each thread reads back only what it staged itself

  double acc = 0.0;
  for (long long g0 = 0; g0 < nrows; g0 += kThreads) {
    const int n = (int)min((long long)kThreads, nrows - g0);
    __syncthreads();  // the last group's table is read
    if (tid < n) {
      // row first + g0 + tid over the outer dims: one row a thread
      long long g = first + g0 + tid;
      long long off[NF] = {};
#pragma unroll
      for (int d = kOuter - 1; d >= 0; --d) {
        if (a.size[d] == 1) continue;
        const long long i = g % a.size[d];
        g /= a.size[d];
#pragma unroll
        for (int k = 0; k < NF; ++k) off[k] += i * a.fs[k][d];
      }
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        if (a.form[k] == ROW_CONSTANT) row_value[k][tid] = __ldg(a.f[k] + off[k]);
        row_offset[k][tid] = off[k];
      }
    }
    __syncthreads();
    const float* xrow = a.x + (first + g0) * a.nx;
    for (int r = 0; r < n; ++r, xrow += a.nx) {
      Vec<VW> xv[kMaxVectors];
#pragma unroll
      for (int j = 0; j < kMaxVectors; ++j) {
        if (valid >> j & 1u) xv[j] = load<VW>(xrow + (col0 + (long long)j * kThreads) * VW);
      }
#pragma unroll
      for (int j = 0; j < kMaxVectors; ++j) {
        if (!(valid >> j & 1u)) continue;
        Vec<VW> fv[NF];
#pragma unroll
        for (int k = 0; k < NF; ++k) {
          if (a.form[k] == ALONG_ROW) {
            fv[k] = load<VW>(a.f[k] + row_offset[k][r] + (col0 + (long long)j * kThreads) * VW);
          } else if (a.form[k] == STAGED) {
            fv[k] = staged[(a.slot[k] * a.vpt + j) * kThreads + tid];
          } else {
#pragma unroll
            for (int e = 0; e < VW; ++e) fv[k].v[e] = row_value[k][r];
          }
        }
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          float m = fv[0].v[e];
#pragma unroll
          for (int k = 1; k < NF; ++k) m = __fmul_rn(m, fv[k].v[e]);
          acc += (double)nan_to_num(__fmul_rn(xv[j].v[e], m));
        }
      }
    }
  }

  // the block's sum in a fixed tree
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFullMask, acc, o);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    a.partial[block] = s;
  }
}

// out[s] = the sum of segment s's partials, a warp a segment, rounded once
__global__ void weighted_sum_finish(const double* partial, float* out, long long segments,
                                    int per_segment) {
  const long long seg = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (seg >= segments) return;  // the whole warp
  const double* p = partial + seg * per_segment;
  double s = 0.0;
  for (int i = lane; i < per_segment; i += 32) s += p[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
  if (lane == 0) out[seg] = __double2float_rn(s);
}

template <int VW, int NF>
int launch_as(const Args& a, long long blocks, int staged, cudaStream_t stream) {
  const size_t smem = (size_t)staged * a.vpt * kThreads * sizeof(Vec<VW>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        weighted_sum_kernel<VW, NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  weighted_sum_kernel<VW, NF><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return 0;
}

template <int VW>
int launch_vw(const Args& a, int nf, long long blocks, int staged, cudaStream_t stream) {
  switch (nf) {
    case 1: return launch_as<VW, 1>(a, blocks, staged, stream);
    case 2: return launch_as<VW, 2>(a, blocks, staged, stream);
    case 3: return launch_as<VW, 3>(a, blocks, staged, stream);
    case 4: return launch_as<VW, 4>(a, blocks, staged, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: contiguous float32 of sizes[kDims] (right-aligned, the leading ones 1);
// factors: nf device pointers, each with strides[k * kDims + d] along x's
// dims (0 where broadcast; the last 0 or 1); segments results out[s], each
// over rows_per_segment rows; vw (4 or 1), vpt, tiles, chunk_rows and
// chunks as ops/kernels/weighted_sum.py's plan; partial holds
// segments * chunks * tiles doubles.
extern "C" int xt_weighted_sum(const void* x, const void* const* factors,
                               const long long* strides, int nf, const long long* sizes,
                               long long segments, long long rows_per_segment, int vw, int vpt,
                               int tiles, long long chunk_rows, int chunks, void* partial,
                               void* out, void* stream) {
  if (nf < 1 || nf > kMaxFactors || vpt < 1 || vpt > kMaxVectors || (vw != 1 && vw != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a = {};
  a.x = static_cast<const float*>(x);
  int staged = 0;
  for (int k = 0; k < nf; ++k) {
    a.f[k] = static_cast<const float*>(factors[k]);
    bool outer = false;
    for (int d = 0; d < kOuter; ++d) {
      a.fs[k][d] = strides[k * kDims + d];
      outer = outer || a.fs[k][d] != 0;
    }
    const bool along = strides[k * kDims + kDims - 1] != 0;
    a.form[k] = !along ? ROW_CONSTANT : outer ? ALONG_ROW : STAGED;
    a.slot[k] = a.form[k] == STAGED ? staged++ : 0;
  }
  for (int d = 0; d < kOuter; ++d) a.size[d] = (int)sizes[d];
  a.nx = sizes[kDims - 1];
  a.rows = rows_per_segment;
  a.chunk_rows = chunk_rows;
  a.chunks = chunks;
  a.tiles = tiles;
  a.vpt = vpt;
  a.partial = static_cast<double*>(partial);
  const long long blocks = segments * chunks * tiles;
  const int status = vw == 4 ? launch_vw<4>(a, nf, blocks, staged, s)
                             : launch_vw<1>(a, nf, blocks, staged, s);
  if (status != 0) return status;
  const int per_segment = chunks * tiles;
  constexpr int kWarps = 8;
  weighted_sum_finish<<<(unsigned)((segments + kWarps - 1) / kWarps), kWarps * 32, 0, s>>>(
      a.partial, static_cast<float*>(out), segments, per_segment);
  return (int)cudaGetLastError();
}
