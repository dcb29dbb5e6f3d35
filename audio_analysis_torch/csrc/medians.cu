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
//   - the lower middle value (rank (n-1)/2) is found exactly by a radix
//     select: four passes over 8-bit digits, most significant first, each a
//     histogram of the entries that match the digits chosen so far, then a
//     scan that picks the digit whose bucket holds the rank;
//   - a successor pass gives the upper middle value (rank n/2): the lower
//     one when its count already covers that rank, else the least value
//     above it;
//   - the median is (f(lo) + f(up)) * 0.5 in float32.
//
// Histograms count integers, so the order of the atomics changes nothing.
//
// Row kernel: one block of 256 threads per row, the row staged once in
// shared memory; each radix pass builds one 256-bin histogram per warp with
// shared-memory atomics, and thread d sums digit d over the warps and takes
// part in a block-wide exclusive scan (4 passes of ~4 barriers).
//
// Column kernel: the same select at the width of a warp, one warp per
// column. What bounds it is the bytes (the spectrogram read once, 25 us a
// recording at 3.35 TB/s), so the design keeps that read in flight while
// the warps search:
//
//   - a persistent block of 8 warps walks over tiles of 8 columns. The
//     tile is staged with 4-byte cp.async (a row of the spectrogram is
//     T * 4 bytes, 41,000 at 60 s, so rows are only 4-byte aligned: no
//     16-byte copies, bulk copies or TMA), transposed so that column c sits
//     at tile[c * ld] with ld = 4 mod 32, which leaves both the staging
//     stores and the column reads free of bank conflicts. A thread issues
//     its ~64 copies without waiting, and its address steps by 32 rows, so
//     no divide sits in the loop;
//   - each warp moves its column into registers (65 values a lane: row r
//     is lane r % 32, slot r / 32), and the tile buffer at once takes the
//     block's next tile, whose copies run under this tile's search; two
//     blocks share an SM (128 registers a thread), so their stagings
//     overlap too;
//   - a first pass takes the column's least and largest values: the
//     leading digits they share are every entry's, so the radix passes
//     start below them, and a column of one value (every column of digital
//     silence is all zero) needs no pass at all;
//   - each pass builds the column's 256-bin histogram in a warp-private
//     1 KB array with one shared-memory atomic per matching entry, then
//     8 bins a lane and a shuffle scan pick the bucket. The last pass's
//     bucket is the lower middle value's own count, so the successor pass
//     runs only when that count falls short of rank n/2 (never for an odd
//     n such as 2049 bins).
//
// Measured on an H100 (PERF.md): the atomics cost one issue per slot
// whether 0, 1 or 32 lanes take part, even all 32 on one address, so
// neither __match_any_sync aggregation nor a vote that skips idle slots pays
// for itself. Two compile-time switches, which only chip_medians_breakdown.py
// passes, time the kernel's parts: -DAAT_COL_STAGE_ONLY (no search) and
// -DAAT_COL_SEARCH_ONLY (each block stages its first tile only and searches
// it for every tile).
//
// A column taller than 32 * 65 rows is searched by the same select reading
// device memory (col_medians_tall_kernel: exact, slower).
// Left for later: one kernel that produces both medians from a single read.

#include <cuda_runtime.h>

#include <map>
#include <mutex>

namespace {

constexpr int INF_BITS = 0x7F800000;
constexpr int TOP = 0x7FFFFFFF;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ROW_THREADS = 256;
constexpr int RADIX = 256;  // 8-bit digits; thread d of a row block owns digit d
constexpr int ROW_WARPS = ROW_THREADS / 32;
static_assert(ROW_THREADS == RADIX, "the row kernel's scan gives each digit one thread");
constexpr int COL_WARPS = 8;       // columns a tile, one warp each
constexpr int COL_MIN_BLOCKS = 2;  // blocks an SM: one stages while another searches
constexpr int COL_THREADS = COL_WARPS * 32;
static_assert(32 % COL_WARPS == 0, "a tile's columns divide a warp");
constexpr int COL_SWEEP = COL_THREADS / COL_WARPS;  // rows a block stages per sweep
constexpr int COL_SLOTS = 65;                       // rows a lane holds in registers
constexpr int COL_STAGED_ROWS = 32 * COL_SLOTS;     // 2080: the tallest staged column
static_assert(RADIX == 32 * 8, "the column scan gives each lane 8 bins");

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
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

// ---------------------------------------------------------------------------
// columns: a warp-wide radix select
// ---------------------------------------------------------------------------

// 4 bytes from device memory to shared memory without passing registers
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// commits this thread's copies and waits for all of them
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// One column's radix select, run by a whole warp. `rows(f)` calls f(v, ok)
// for every slot of the lane's rows (row r is lane r % 32), in the same
// number of calls on every lane; ok is false past the column's end. `h` is
// the warp's 256-bin histogram, all zero on entry and on return. The passes
// start at digit `shift` (the digits above it are `prefix` in every entry).
// Returns the value of rank k (bits); `below` gets the count of entries below
// it and `equal` the count of entries equal to it.
template <class Rows>
__device__ __forceinline__ int warp_radix_select(const Rows& rows, int k, int shift, int prefix,
                                                 int* h, int lane, int& below, int& equal) {
  int mask = shift < 24 ? -(1 << (shift + 8)) : 0;
  below = 0;
#pragma unroll 1
  for (; shift >= 0; shift -= 8) {
    rows([&](int v, bool ok) {
      if (ok && (v & mask) == prefix) atomicAdd(&h[(v >> shift) & (RADIX - 1)], 1);
    });
    __syncwarp();
    // lane L scans bins 8L .. 8L + 7
    int4* h4 = reinterpret_cast<int4*>(h);
    const int4 a = h4[2 * lane], b = h4[2 * lane + 1];
    const int c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    int total = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) total += c[i];
    int run = warp_inclusive_sum(total, lane) - total;
    int digit = 0, before = 0, count = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // exactly one bin of one lane holds rank k
      if (run <= k && k < run + c[i]) {
        digit = 8 * lane + i;
        before = run;
        count = c[i];
      }
      run += c[i];
    }
    const int src = __ffs(__ballot_sync(FULL, count > 0)) - 1;
    digit = __shfl_sync(FULL, digit, src);
    before = __shfl_sync(FULL, before, src);
    count = __shfl_sync(FULL, count, src);
    h4[2 * lane] = make_int4(0, 0, 0, 0);
    h4[2 * lane + 1] = make_int4(0, 0, 0, 0);
    __syncwarp();
    prefix |= digit << shift;
    mask |= (RADIX - 1) << shift;
    k -= before;
    below += before;
    equal = count;
  }
  return prefix;
}

// np.median of a column of n values, by the whole warp (every lane gets it).
// A first pass finds the column's least and largest values: the leading
// digits they share are every entry's, so the radix passes start below them,
// and a column of one value (all zero, in digital silence) needs none.
template <class Rows>
__device__ __forceinline__ float column_median(const Rows& rows, int n, int* h, int lane) {
  int least = TOP, most = 0;
  rows([&](int v, bool ok) {
    if (ok) {
      least = min(least, v);
      most = max(most, v);
    }
  });
  least = warp_min(least);
  most = -warp_min(-most);
  int shift = 24;
  while (shift >= 0 && (least >> shift) == (most >> shift)) shift -= 8;
  int lo = least, below = 0, equal = n;
  if (shift >= 0) {
    const int prefix = shift < 24 ? least & -(1 << (shift + 8)) : 0;
    lo = warp_radix_select(rows, (n - 1) / 2, shift, prefix, h, lane, below, equal);
  }
  int up = lo;
  if (below + equal < n / 2 + 1) {  // rank n/2 lies above lo: the least value above it
    int s = TOP;
    rows([&](int v, bool ok) {
      if (ok && v > lo) s = min(s, v);
    });
    up = warp_min(s);
  }
  return median_of(lo, up);
}

// cp.async the rows of tile g (batch b, columns c0 .. c0 + COL_WARPS) into
// `tile`, column c at tile[c * ld]: thread t copies column t % COL_WARPS,
// rows t / COL_WARPS + COL_SWEEP * i.
__device__ __forceinline__ void stage_tile(int* tile, const int* __restrict__ spec, int g,
                                           int n_ct, int bins, int T, int ld) {
  const int b = g / n_ct, c0 = (g - b * n_ct) * COL_WARPS;
  const int c = threadIdx.x % COL_WARPS, r0 = threadIdx.x / COL_WARPS;
  if (c0 + c >= T) return;
  const int* src = spec + ((long)b * bins + r0) * T + c0 + c;
  const long step = (long)COL_SWEEP * T;
  int* dst = tile + c * ld;
#pragma unroll 4
  for (int r = r0; r < bins; r += COL_SWEEP, src += step) cp_async4(dst + r, src);
}

// Persistent blocks over B * ceil(T / COL_WARPS) tiles; block COL_THREADS,
// dynamic shared memory COL_WARPS * ld ints; out [B, T]. bins <= COL_STAGED_ROWS.
__global__ void __launch_bounds__(COL_THREADS, COL_MIN_BLOCKS)
col_medians_kernel(const int* __restrict__ spec, float* __restrict__ out, int B, int bins,
                   int T, int ld) {
  extern __shared__ __align__(16) int tile[];
  __shared__ __align__(16) int hist[COL_WARPS][RADIX];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_ct = (T + COL_WARPS - 1) / COL_WARPS, n_tiles = B * n_ct;
  for (int i = lane; i < RADIX; i += 32) hist[warp][i] = 0;
  __syncwarp();
  stage_tile(tile, spec, blockIdx.x, n_ct, bins, T, ld);  // the grid is at most n_tiles
  for (int g = blockIdx.x; g < n_tiles; g += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // tile g has arrived
    const int b = g / n_ct, col = (g - b * n_ct) * COL_WARPS + warp;
#ifndef AAT_COL_STAGE_ONLY
    int x[COL_SLOTS];
#pragma unroll
    for (int j = 0; j < COL_SLOTS; ++j) {
      const int r = 32 * j + lane;
      x[j] = r < bins ? tile[warp * ld + r] : 0;
    }
#endif
    __syncthreads();  // the columns are in registers: the buffer takes the next tile
#ifndef AAT_COL_SEARCH_ONLY
    if (g + gridDim.x < n_tiles) stage_tile(tile, spec, g + gridDim.x, n_ct, bins, T, ld);
#endif
    if (col >= T) continue;  // warp-uniform
#ifdef AAT_COL_STAGE_ONLY
    if (lane == 0) out[(long)b * T + col] = 0.f;
#else
    const auto rows = [&](auto f) {
#pragma unroll
      for (int j = 0; j < COL_SLOTS; ++j) {
        if (32 * j >= bins) break;
        f(x[j], 32 * j + lane < bins);
      }
    };
    const float m = column_median(rows, bins, hist[warp], lane);
    if (lane == 0) out[(long)b * T + col] = m;
#endif
  }
}

// Columns taller than COL_STAGED_ROWS, read from device memory. grid
// (ceil(T / COL_WARPS), B), block COL_THREADS: one warp per column.
__global__ void __launch_bounds__(COL_THREADS)
col_medians_tall_kernel(const int* __restrict__ spec, float* __restrict__ out, int bins,
                        int T) {
  __shared__ __align__(16) int hist[COL_WARPS][RADIX];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = lane; i < RADIX; i += 32) hist[warp][i] = 0;
  __syncwarp();
  const int b = blockIdx.y, col = blockIdx.x * COL_WARPS + warp;
  if (col >= T) return;  // no block-wide barrier follows
  const int* p = spec + (long)b * bins * T + col;
  const auto rows = [&](auto f) {
    for (int j0 = 0; j0 < bins; j0 += 32) {
      const int r = j0 + lane;
      f(r < bins ? p[(long)r * T] : 0, r < bins);
    }
  };
  const float m = column_median(rows, bins, hist[warp], lane);
  if (lane == 0) out[(long)b * T + col] = m;
}

int max_smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

// The blocks of col_medians_kernel that the current device holds at once
// with `smem` bytes of dynamic shared memory a block (SMs x blocks an SM),
// after raising the kernel's shared-memory limit to `smem` where it was
// lower. Cached per device: the answer for one size never changes, and the
// queries would cost host time on every launch.
int col_resident_blocks(size_t smem) {
  struct Entry {
    size_t smem_set = 0, smem = 0;
    int blocks = 0;
  };
  static std::mutex mu;
  static std::map<int, Entry> cache;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  Entry& e = cache[dev];
  if (smem > e.smem_set) {
    cudaFuncSetAttribute(col_medians_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    e.smem_set = smem;
  }
  if (e.blocks == 0 || e.smem != smem) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, col_medians_kernel, COL_THREADS,
                                                  smem);
    e.smem = smem;
    e.blocks = max(per_sm, 1) * sms;
  }
  return e.blocks;
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
  const long n_ct = (T + COL_WARPS - 1) / COL_WARPS;
  if (bins > COL_STAGED_ROWS) {
    if (B > 65535) return (int)cudaErrorInvalidValue;
    col_medians_tall_kernel<<<dim3((unsigned)n_ct, B), COL_THREADS, 0,
                              (cudaStream_t)stream>>>((const int*)spec, out, bins, T);
    return (int)cudaGetLastError();
  }
  if ((long)B * n_ct > 0x7FFFFFFFL) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)((long)B * n_ct);
  // ld % 32 == 32 / COL_WARPS: the staging stores are free of bank conflicts
  const int ld = bins + (32 + 32 / COL_WARPS - bins % 32) % 32;
  const size_t smem = sizeof(int) * (size_t)COL_WARPS * ld;
  const int grid = min(n_tiles, col_resident_blocks(smem));
  col_medians_kernel<<<grid, COL_THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)spec, out, B, bins, T, ld);
  return (int)cudaGetLastError();
}

}  // extern "C"
