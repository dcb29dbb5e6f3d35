// Exact masked medians of a non-negative float32 spectrogram, for Hopper
// (sm_90a).
//
// row_medians replaces the Pallas kernel audio_analysis_tpu/ops/pallas/
// medians.py :: _kernel_row_medians; col_medians replaces
// medians.py :: _kernel_col_medians. Both find the same two order
// statistics as medians.py :: _search (and the XLA path
// detect/signal_noise.py :: _masked_medians_rowcol), so the result is
// bit-identical to np.median:
//
//   - the values are read as int32 bit patterns (monotone for x >= 0, and
//     bit 31 is always 0); masked entries (row columns >= nvf[b]) become
//     the +inf pattern once;
//   - the lower middle value (rank (n-1)/2) is found exactly: by a radix
//     select on the rows (four passes over 8-bit digits, most significant
//     first: a histogram of the entries that match the digits chosen so
//     far, then a scan picks the digit whose bucket holds the rank), and
//     by 31 binary narrowing steps, each counting x <= m, on the columns;
//   - a successor pass gives the upper middle value (rank n/2): the lower
//     one when its count already covers that rank, else the least value
//     above it;
//   - the median is (f(lo) + f(up)) * 0.5 in float32.
//
// Design: a line (a row over T columns, or a column over all rows) is
// staged once in shared memory and searched there, so device memory is read
// once per element. Row kernel: one block of 256 threads per row; each
// radix pass builds one 256-bin histogram per warp with shared-memory
// atomics (integer counts, so the order of the atomics changes nothing),
// and thread d sums digit d over the warps and takes part in a block-wide
// exclusive scan: 4 passes and ~4 barriers each, where the binary search
// took 32 passes of 3 barriers. Column kernel: one warp per column, a block
// stages a [TC, rows] tile transposed (columns contiguous) and each warp
// reduces with shuffles. When a line does not fit in shared memory the same
// search reads it from device memory instead (still exact, slower).
//
// What bounds it: the bytes (the spectrogram read once; the passes run
// over shared memory). Left for later: the radix select for the columns,
// a TMA bulk copy of each row, and one kernel that produces both medians
// from a single read.

#include <cuda_runtime.h>

namespace {

constexpr int INF_BITS = 0x7F800000;
constexpr int TOP = 0x7FFFFFFF;
constexpr int N_NARROW = 31;
constexpr int ROW_THREADS = 256;
constexpr int RADIX = 256;  // 8-bit digits; thread d of a row block owns digit d
constexpr int ROW_WARPS = ROW_THREADS / 32;
static_assert(ROW_THREADS == RADIX, "the row kernel's scan gives each digit one thread");
constexpr int COL_WARPS = 16;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions; every thread gets the result. `red` holds 33 ints.
__device__ int block_sum(int v, int* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();  // red may still be read from the previous reduction
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0;
    v = warp_sum(v);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

__device__ int block_min(int v, int* red) {
  v = warp_min(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : TOP;
    v = warp_min(v);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

__device__ __forceinline__ float median_of(int lo, int up) {
  return (__int_as_float(lo) + __int_as_float(up)) * 0.5f;
}

// A line of n values: element j is line[j * stride] (bits); entries j >= n_valid
// read as +inf.
struct Line {
  const int* p;
  long stride;
  int n, n_valid;
  __device__ __forceinline__ int at(int j) const {
    return j < n_valid ? p[j * stride] : INF_BITS;
  }
};

// The value of rank k among line[0 .. T) (bits), by a most-significant-
// digit radix select. Every thread gets it.
__device__ int radix_select(const Line& line, int T, int k, int (*hist)[RADIX], int* red,
                            int* pick) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int prefix = 0, mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < ROW_WARPS * RADIX; i += ROW_THREADS) (&hist[0][0])[i] = 0;
    __syncthreads();
    for (int j = threadIdx.x; j < T; j += ROW_THREADS) {
      const int v = line.at(j);
      if ((v & mask) == prefix) atomicAdd(&hist[wid][(v >> shift) & (RADIX - 1)], 1);
    }
    __syncthreads();
    int c = 0;
#pragma unroll
    for (int q = 0; q < ROW_WARPS; ++q) c += hist[q][threadIdx.x];
    int incl = c;  // inclusive scan over the block: warps, then warp totals
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) red[wid] = incl;
    __syncthreads();
    int excl = incl - c;
    for (int q = 0; q < wid; ++q) excl += red[q];
    if (excl <= k && k < excl + c) {  // exactly one digit's bucket holds rank k
      pick[0] = threadIdx.x;
      pick[1] = excl;
    }
    __syncthreads();
    prefix |= pick[0] << shift;
    mask |= (RADIX - 1) << shift;
    k -= pick[1];
  }
  return prefix;
}

// grid (bins, B), block ROW_THREADS; out [B, bins]
__global__ void __launch_bounds__(ROW_THREADS)
row_medians_kernel(const int* __restrict__ spec, const int* __restrict__ nvf,
                   float* __restrict__ out, int bins, int T, int staged) {
  extern __shared__ int buf[];
  __shared__ int hist[ROW_WARPS][RADIX];
  __shared__ int red[33];
  __shared__ int pick[2];
  const int r = blockIdx.x, b = blockIdx.y;
  const int nv = min(nvf[b], T);
  const int* src = spec + ((long)b * bins + r) * T;
  Line line{src, 1, T, nv};
  if (staged) {
    for (int j = threadIdx.x; j < T; j += blockDim.x) buf[j] = line.at(j);
    __syncthreads();
    line = Line{buf, 1, T, T};
  }
  const int k2 = nv / 2;
  const int lo = radix_select(line, T, (nv - 1) / 2, hist, red, pick);
  int c = 0, s = INF_BITS;
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    const int v = line.at(j);
    c += v <= lo;
    if (v > lo) s = min(s, v);
  }
  c = block_sum(c, red);
  s = block_min(s, red);
  if (threadIdx.x == 0) out[(long)b * bins + r] = median_of(lo, c >= k2 + 1 ? lo : s);
}

// grid (ceil(T / tc), B), block tc warps; out [B, T]
__global__ void __launch_bounds__(COL_WARPS * 32)
col_medians_kernel(const int* __restrict__ spec, float* __restrict__ out, int bins,
                   int T, int staged) {
  extern __shared__ int tile[];  // [tc, bins]: column c at tile[c * bins]
  const int tc = blockDim.x >> 5;
  const int b = blockIdx.y, c0 = blockIdx.x * tc;
  const int ncols = min(tc, T - c0);
  const int* base = spec + (long)b * bins * T;
  if (staged) {
    for (int i = threadIdx.x; i < bins * tc; i += blockDim.x) {
      const int r = i / tc, c = i - r * tc;
      if (c < ncols) tile[c * bins + r] = base[(long)r * T + c0 + c];
    }
    __syncthreads();
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= ncols) return;  // no block-wide barrier follows
  const Line line = staged ? Line{tile + warp * bins, 1, bins, bins}
                           : Line{base + c0 + warp, T, bins, bins};
  const int k1 = (bins - 1) / 2, k2 = bins / 2;
  int lo = 0, hi = TOP;
  for (int it = 0; it < N_NARROW; ++it) {
    const int m = lo + (hi - lo) / 2;
    int c = 0;
    for (int j = lane; j < bins; j += 32) c += line.at(j) <= m;
    c = warp_sum(c);
    if (c >= k1 + 1) hi = m; else lo = m + 1;
  }
  int c = 0, s = INF_BITS;
  for (int j = lane; j < bins; j += 32) {
    const int v = line.at(j);
    c += v <= lo;
    if (v > lo) s = min(s, v);
  }
  c = warp_sum(c);
  s = warp_min(s);
  if (lane == 0) out[(long)b * T + c0 + warp] = median_of(lo, c >= k2 + 1 ? lo : s);
}

int max_smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

}  // namespace

extern "C" {

// spec [B, bins, T] float32 (>= 0), nvf [B] int32; out [B, bins]: the median
// of each row over its first nvf[b] columns.
int aat_row_medians(const float* spec, const int* nvf, float* out, int B, int bins,
                    int T, void* stream) {
  if (B <= 0 || bins <= 0 || T <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const size_t need = sizeof(int) * (size_t)T;
  // the block's static histograms and reduction buffers share the same
  // shared memory
  const size_t fixed = sizeof(int) * ((size_t)ROW_WARPS * RADIX + 64);
  const int staged = need + fixed <= (size_t)max_smem_optin();
  const size_t smem = staged ? need : 0;
  cudaFuncSetAttribute(row_medians_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  row_medians_kernel<<<dim3(bins, B), ROW_THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)spec, nvf, out, bins, T, staged);
  return (int)cudaGetLastError();
}

// spec [B, bins, T] float32 (>= 0); out [B, T]: the median of each column
// over all bins rows.
int aat_col_medians(const float* spec, float* out, int B, int bins, int T,
                    void* stream) {
  if (B <= 0 || bins <= 0 || T <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const size_t line = sizeof(int) * (size_t)bins;
  int tc = (int)((size_t)max_smem_optin() / line);
  const int staged = tc >= 1;
  tc = staged ? min(tc, COL_WARPS) : COL_WARPS / 2;
  const size_t smem = staged ? line * tc : 0;
  cudaFuncSetAttribute(col_medians_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  col_medians_kernel<<<dim3((T + tc - 1) / tc, B), tc * 32, smem, (cudaStream_t)stream>>>(
      (const int*)spec, out, bins, T, staged);
  return (int)cudaGetLastError();
}

}  // extern "C"
