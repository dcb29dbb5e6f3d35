// Framed DFT -> |X|^power -> mel on the bf16 tensor cores, for Hopper
// (sm_90a). Two routes of one contract (bf16 operands, float32 sums):
//
//   dif    (stft_mel_dif_bf16_kernel) replaces the Pallas kernel
//          audio_analysis_tpu/ops/pallas/melspec.py:391 :: _kernel_dif at
//          its exact=0 level, the factored DFT that the fast level runs for
//          n_fft % 8 == 0;
//   direct (stft_mel_bf16_kernel) replaces melspec.py:98 :: _kernel, the
//          direct DFT-as-GEMM, for any other n_fft (or AAT_PALLAS_ALG=matmul).
//
// Framing, for both: frame t of window x[S] is x[t*hop - n_fft/2 ..
// t*hop - n_fft/2 + n_fft), zero outside [0, S) (centre framing with
// constant padding), so no framed matrix exists in device memory; each
// sample is rounded to bf16.
//
// ---- direct route -------------------------------------------------------
//
// What it computes, as stft_mel_bf16_plain: re = frame . Wr and im = frame
// . Wi over the first bins (the mel filterbank's support), where Wr = cos *
// hann and Wi = -sin * hann are the Hann-folded DFT matrices, built in
// float64 on the host and rounded to float32 and then to bf16; products
// are bf16 x bf16 summed in float32. p = re^2 + im^2 in float32, then sqrt
// for power 1 or p^(power/2) for any power but 2; p is rounded to bf16 and
// out[w][m][t] = sum_k p_k M[m][k], again bf16 x bf16 into float32.
//
// What bounds it: as a function, the bytes (the float32 PCM read once, the
// output written once). As a GEMM it does 4 * bins * n_fft tensor-core
// operations a frame: 266 GFLOP on the n_fft-4410 classify grid, 0.27 ms
// at the bf16 peak against 0.014 ms of bytes. Each K chunk of a 128-frame x
// 64-bin pass brings 32 KB of operands from L2 for 2.1 MFLOP, so at the
// tensor-core rate the SMs would draw ~15 TB/s from L2: the operand
// traffic and the pipeline, not the tensor cores, limit it.
//
// Design:
//  - frame classes: with P = 8 / gcd(hop, 8), frame t = v + P u is the u-th
//    of class v. A pre-pass (direct_frames_kernel) writes P bf16 copies of
//    each window, n_fft/2 zeros on the left and zeros past its end, copy c
//    shifted left by c * gcd(hop, 8) samples: each sample is rounded once,
//    each frame starts 16-byte aligned in one copy, and a class's frames
//    lie P * hop samples apart, a multiple of 16 bytes. So one 4-D TMA box
//    (samples < n_fft, 8-sample blocks, a class's frames, copy rows; the
//    frame stride overlaps the samples; cuTensorMapEncodeTiled takes it) fetches a
//    class's frames of a K chunk with the 128-byte swizzle;
//  - a work item is (window, class, 128 frames of the class): 128 rows,
//    one TMA box a K chunk. The copies take P times the window's bf16
//    bytes of scratch (the host allocates it: ops/melspec.py ::
//    direct_tiles);
//  - persistent blocks of three warpgroups walk over the items; an item
//    walks the support in passes of 64 bins, a pass walks n_fft in K chunks
//    of 64 samples (one 128-byte row);
//  - a ring of 4 shared-memory stages, each the chunk of the item's frames
//    [128 x 64] and of Wr and Wi [64 + 64 rows x 64], with a full and an
//    empty mbarrier a stage. One thread of the producer warpgroup starts
//    the TMA loads (the frames' box, Wr, Wi) up to 4 chunks ahead;
//  - two consumer warpgroups (setmaxnreg: 232 registers, the producer 40)
//    each own 64 rows. Per K step of 16 one wgmma m64n128k16 takes re and
//    im of its 64 rows x 64 bins (B is the Wr rows then the Wi rows), one
//    group in flight while the next chunk's are started; each warp frees a
//    stage once its products are done;
//  - after a pass, p is computed in registers and packed to bf16 straight
//    into the A-fragment layout of a second wgmma (m64n32k16, A from
//    registers) against the pass's [mel_rows x 64] mel tile (TMA, two
//    buffers), accumulating [64 rows x mel_rows] in registers across
//    passes. The item's [n_mels x 64] tiles are written from registers
//    (frames contiguous for P = 1) while the producer already fills the
//    ring for the next item.
// Against the shape first proposed for it: the two warpgroups split the
// frames, not 128 bins over 64 frames, which would bring 40 KB a chunk for
// the same work and leave partial mel sums to add through shared memory;
// and the frames come by TMA for every hop: copied by index (cp.async) a
// chunk took several times as long on the card. Every output element
// is summed by one warpgroup in one fixed order, with no atomics, so two
// launches agree bit for bit. K past n_fft is zero in both operands (zero
// columns of Wr and Wi; the frames outside the tensor map), so an all-zero
// frame gives exact zeros; rows never mix windows, and rows past n_out
// (which may read beyond the frames asked for) are never stored. A wait on
// a barrier that never completes traps (after ~2^34 clocks) rather than
// hang the process.
//
// ---- dif route ----------------------------------------------------------
//
// What it computes, step for step as _kernel_dif(exact=0): the bf16 sample
// times the float32 Hann window; an L-level radix-2 decimation-in-frequency
// split in float32 (level l twiddles cos/sin(2 pi p / (n_fft >> l)) for
// p < n_fft >> (l + 1), one table a level, laid end to end)
// into 2^L leaves of m_leaf = n_fft / 2^L points, leaf b holding bins
// 2^L j + bitrev_L(b); each leaf rounded to bf16 and its DFT taken against
// the bf16 leaf matrices C = cos, S = sin [m_leaf, bl] with float32 sums:
// xr = r.C + i.S, xi = i.C - r.S; p = |X|^power in float32, rounded to bf16,
// times the leaf-permuted mel rows (bf16), summed in float32. The split
// uses explicitly rounded float32 products and sums (no fused multiply-add)
// so it rounds as the plain version does.
//
// Design: a block of 16 warps owns TFD = 16 consecutive frames of one
// window (one m16 row tile). It stages the PCM span the frames cover,
// (TFD - 1) hop + n_fft samples, once in shared memory as bf16. The leaves
// are taken in groups of 8: the first L - 3 levels of the split only select
// the group's branch, the last 3 levels run in full. Warp w takes leaf
// w % 8 of the group and half w / 8 of its bins (<= 64 a pass, so xr and xi
// live in 64 registers). For each group, a K loop over the leaf positions in
// chunks of KCD = 64, in two shared-memory stages: after one barrier the
// [bins x 64] chunks of C and S for chunk c + 1 are started with cp.async,
// the warps run mma.sync m16n8k16 on chunk c (xr += r.C + i.S, xi += i.C +
// (-r).S: negating a bf16 operand is exact; leaf 0 is real and skips its i
// terms), and then each thread runs the float32 split of one (frame,
// position) of chunk c + 1 in registers and writes the group's 8 bf16 leaf
// values (real and imaginary) to the other stage, so the split of one
// chunk overlaps the tensor-core work of the warps still on the last one.
// C and S are shared by the 8 leaves of the group. The epilogue computes p
// in registers and writes it as bf16 to a [16 frames x 8 leaves x bins]
// tile in shared memory; the mel product over that tile then runs with the
// mel tiles split across the warps and the mel rows streamed from L2,
// accumulating in registers across groups and bin tiles. Every output
// element is written by one block, with no atomics, so two launches agree
// bit for bit; an all-zero frame gives exact zeros (no sum mixes frames).
// Offsets into a window are 64-bit.
//
// What bounds it: as a function, the bytes (the float32 PCM read once, the
// output written once) at the main path's shapes. Its tensor-core work is
// (2 + 4 (2^L - 1)) m_leaf bl products a frame: 3.9 MFLOP at classify
// (n_fft 4096, L 3, bl 128) and 3.0 at the end-scan (4800, L 4, bl 80),
// against 15.7 and 22.1 for the direct route. It runs far from both
// bounds: mma.sync rather than wgmma, one 512-thread block per SM (128
// registers a thread), a barrier per K chunk, and only 16 frames to share
// each block's reads of C, S and the mel rows from L2. Left for later:
// wgmma on 64-frame tiles with the split done by a producer warpgroup.

#include <cuda.h>  // CUtensorMap and its enums (cuTensorMapEncodeTiled comes through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a . b for one m16n8k16 tile (A row-major 16x16, B column-major 16x8)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float power_of(float p2, float power) {
  if (power == 2.f) return p2;
  if (power == 1.f) return sqrtf(p2);
  return powf(p2, 0.5f * power);
}

// Raise `kernel`'s dynamic shared-memory limit to `smem` on the current
// device, once per (device, kernel, size): the attribute holds until it is
// raised again, and setting it on every launch costs host time.
cudaError_t allow_smem(const void* kernel, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> set;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = set[{dev, kernel}];
  if (smem > have) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    have = smem;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// direct route
// ---------------------------------------------------------------------------

constexpr int DF = 128;               // frames a work item: 64 a consumer warpgroup
constexpr int DB = 64;                // DFT bins a pass
constexpr int DK = 64;                // samples a K chunk: a 128-byte row of bf16
constexpr int DSTAGES = 4;            // ring stages
constexpr int D_THREADS = 384;        // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int A_BYTES = DF * DK * 2;  // a chunk of the frames [128 x 64] bf16
constexpr int B_BYTES = 2 * DB * DK * 2;  // Wr rows then Wi rows [64 + 64 x 64] bf16
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr long long WATCHDOG_CLOCKS = 1LL << 34;

struct DirectArgs {
  float* out;     // [n_windows, n_mels, n_out]
  int classes;    // P = 8 / gcd(hop, 8): the frame classes t % P
  int shift;      // gcd(hop, 8): copy c of a window is shifted left by c * shift samples
  int n_out, hop, n_tiles, n_items, n_chunks, n_passes, n_mels;
  float power;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of TMA transfers to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  long long start = 0;
  for (int spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023) == 1023) {
      const long long now = clock64();
      if (start == 0) start = now;
      else if (now - start > WATCHDOG_CLOCKS) __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle (rows of 128 bytes, 8-row groups 1024 bytes apart; the tile
// 1024-byte aligned). Adding 2 moves the start 32 bytes: one K step of 16.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of r across a wgmma wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[0..64) += A[64 x 16] . B[128 x 16]^T, both from shared memory (K-major,
// 128-byte swizzle); scale_d 0 overwrites d instead
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0..16) += A[64 x 16] . B[32 x 16]^T, A from registers (each warp's 16
// rows as the m16n8k16 A fragment), B from shared memory (K-major, 128-byte
// swizzle)
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The pre-pass: row (w, c) of xb, c < copies, holds window w with n_fft/2
// zeros on its left, shifted left by c * shift samples: xb[w][c][j] =
// bf16(x[w][j + c * shift - n_fft/2]) inside the window, else 0, for j <
// lfill (a multiple of 8: the samples of the frames asked for); two samples
// a thread. Rows are lrow apart; what lies past lfill is read only for
// frames past n_out, whose rows are never stored.
__global__ void direct_frames_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ xb,
                                     int n_rows, int copies, int shift, long S, long lrow,
                                     long lfill, int half) {
  const long pairs = (long)n_rows * (lfill / 2);
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < pairs;
       i += (long)gridDim.x * blockDim.x) {
    const long row = i / (lfill / 2);
    const long j = (i - row * (lfill / 2)) * 2;
    const long w = row / copies;
    const long s = j + (row - w * copies) * shift - half;
    const float* xw = x + w * S;
    const float v0 = s >= 0 && s < S ? xw[s] : 0.f;
    const float v1 = s + 1 >= 0 && s + 1 < S ? xw[s + 1] : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(xb + row * lrow + j) = __floats2bfloat162_rn(v0, v1);
  }
}

// Frame classes: with P = classes, frame t = v + P u is u-th of class v.
// A work item is a window w, a class v and a tile i of n_tiles along u:
// row r of the item's frames holds frame v + P (128 i + r), fetched by one
// TMA box a K chunk. P = 1 is 128 consecutive frames.
__device__ __forceinline__ void direct_item(const DirectArgs& a, int item, int& w, int& v,
                                            int& u0) {
  w = item / (a.classes * a.n_tiles);
  const int rem = item - w * a.classes * a.n_tiles;
  v = rem / a.n_tiles;
  u0 = (rem - v * a.n_tiles) * DF;
}

// Persistent: block b takes work items b, b + gridDim.x, ... (direct_item);
// MR mel rows (a multiple of 32).
template <int MR>
__global__ void __launch_bounds__(D_THREADS, 1)
stft_mel_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_wr,
                     const __grid_constant__ CUtensorMap map_wi,
                     const __grid_constant__ CUtensorMap map_mel, const DirectArgs a) {
  constexpr int NC = MR / 32;                // m64n32 mel products a K step
  constexpr uint32_t MEL_BYTES = MR * DB * 2;  // a pass's mel tile [MR x 64] bf16
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* mel_buf = smem + DSTAGES * STAGE_BYTES;  // [2][MR x 64]
  uint64_t* full = reinterpret_cast<uint64_t*>(mel_buf + 2 * MEL_BYTES);
  uint64_t* empty = full + DSTAGES;
  uint64_t* mel_full = empty + DSTAGES;
  uint64_t* mel_empty = mel_full + 2;

  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DSTAGES; ++s) {
      // full: the producer's arrival with the TMA bytes; empty: each
      // consumer warp's
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&mel_full[b], 1);
      mbar_init(&mel_empty[b], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 256) return;
    int it = 0, jt = 0;  // chunks and passes so far: ring and mel-buffer positions
    for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
      int w, v, u0;
      direct_item(a, item, w, v, u0);
      // frames from t = v + P u0, at element e = t hop of the padded window,
      // 16-byte aligned in copy (e % 8) / shift
      const long e = (long)(v + a.classes * u0) * a.hop;
      const int sh = (int)(e & 7);
      for (int j = 0; j < a.n_passes; ++j, ++jt) {
        const int mb = jt & 1;
        mbar_wait(&mel_empty[mb], ((jt >> 1) & 1) ^ 1);
        mbar_expect_tx(&mel_full[mb], MEL_BYTES);
        tma_load_2d(mel_buf + mb * MEL_BYTES, &map_mel, &mel_full[mb], j * DB, 0);
        for (int c = 0; c < a.n_chunks; ++c, ++it) {
          const int s = it % DSTAGES;
          unsigned char* st = smem + s * STAGE_BYTES;
          mbar_wait(&empty[s], ((it / DSTAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], STAGE_BYTES);
          tma_load_4d(st, &map_x, &full[s], c * DK, (int)((e - sh) >> 3), 0,
                      w * a.classes + sh / a.shift);
          tma_load_2d(st + A_BYTES, &map_wr, &full[s], c * DK, j * DB);
          tma_load_2d(st + A_BYTES + B_BYTES / 2, &map_wi, &full[s], c * DK, j * DB);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows wg*64 .. wg*64 + 63 of an item ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    int it = 0, jt = 0;
    for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
      int w, v, u0;
      direct_item(a, item, w, v, u0);
      float mel[NC][16];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 16; ++e) mel[n][e] = 0.f;

      for (int j = 0; j < a.n_passes; ++j, ++jt) {
        // acc[0..32): re of bins 0..63 of the pass, acc[32..64): im
        float acc[64];
        int prev = 0;
        for (int c = 0; c < a.n_chunks; ++c, ++it) {
          const int s = it % DSTAGES;
          const unsigned char* st = smem + s * STAGE_BYTES;
          mbar_wait(&full[s], (it / DSTAGES) & 1);
          const uint64_t da = sw128_desc(st + wg * (A_BYTES / 2));
          const uint64_t db = sw128_desc(st + A_BYTES);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < DK / 16; ++ks)
            wgmma_m64n128k16_ss(acc, da + 2 * ks, db + 2 * ks, c > 0 || ks > 0);
          wgmma_commit();
          wgmma_wait<1>();  // the previous chunk's products are done
          if (c > 0 && lane == 0) mbar_arrive(&empty[prev]);
          prev = s;
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(&empty[prev]);

        // |X|^power rounded to bf16, packed as the A fragment of K step ks
        // (bins 16 ks .. 16 ks + 15: accumulator n8 tiles 2 ks, 2 ks + 1)
        uint32_t pa[DB / 16][4];
#pragma unroll
        for (int ks = 0; ks < DB / 16; ++ks) {
          float p[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float r = acc[8 * ks + e], i = acc[32 + 8 * ks + e];
            p[e] = power_of(r * r + i * i, a.power);
          }
          pa[ks][0] = pack_bf16(p[0], p[1]);  // row g,     bins 2q, 2q + 1
          pa[ks][1] = pack_bf16(p[2], p[3]);  // row g + 8
          pa[ks][2] = pack_bf16(p[4], p[5]);  // row g,     bins 8 + 2q, 8 + 2q + 1
          pa[ks][3] = pack_bf16(p[6], p[7]);  // row g + 8
        }
        const int mb = jt & 1;
        mbar_wait(&mel_full[mb], (jt >> 1) & 1);
        const uint64_t dm = sw128_desc(mel_buf + mb * MEL_BYTES);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < DB / 16; ++ks)
#pragma unroll
          for (int n = 0; n < NC; ++n)
            wgmma_m64n32k16_rs(mel[n], pa[ks], dm + n * (32 * 128 >> 4) + 2 * ks);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int n = 0; n < NC; ++n) fence_regs(mel[n]);
        if (lane == 0) mbar_arrive(&mel_empty[mb]);
      }

      // the item's [n_mels x 64] tile of this warpgroup (frames contiguous
      // for P = 1)
      float* ow = a.out + (long)w * a.n_mels * a.n_out;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wg * 64 + warp * 16 + g + 8 * h;
        const int t = v + a.classes * (u0 + row);
        if (t < a.n_out) {
#pragma unroll
          for (int n = 0; n < NC; ++n)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int m = n * 32 + jj * 8 + 2 * q + e;
                if (m < a.n_mels) ow[(long)m * a.n_out + t] = mel[n][4 * jj + 2 * h + e];
              }
        }
      }
    }
  }
}

size_t direct_smem(int mel_rows) {
  return 1024 + (size_t)DSTAGES * STAGE_BYTES + 2 * (size_t)mel_rows * DB * 2 +
         sizeof(uint64_t) * (2 * DSTAGES + 4);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point lookup, so the
// library links no libcuda; null where the installed CUDA lacks it
EncodeTiled encode_tiled() {
  static std::once_flag once;
  static EncodeTiled fn = nullptr;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first; strides in bytes of
// dims 1..), box `box`, 128-byte swizzle; reads outside the dims give zeros.
bool encode_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                 const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(base),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MR>
cudaError_t launch_direct(const CUtensorMap& mx, const CUtensorMap& mr, const CUtensorMap& mi,
                          const CUtensorMap& mm, const DirectArgs& a, int sms,
                          cudaStream_t st) {
  const size_t smem = direct_smem(MR);
  const cudaError_t err = allow_smem((const void*)stft_mel_bf16_kernel<MR>, smem);
  if (err != cudaSuccess) return err;
  const int grid = a.n_items < sms ? a.n_items : sms;
  stft_mel_bf16_kernel<MR><<<grid, D_THREADS, smem, st>>>(mx, mr, mi, mm, a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dif route
// ---------------------------------------------------------------------------

constexpr int TFD = 16;       // frames per block: one m16 row tile
constexpr int KCD = 64;       // leaf positions per K chunk
constexpr int LDD = KCD + 8;  // row stride (bf16) of the leaf and C/S chunks
constexpr int GROUP = 8;      // leaves per group, one per warp
constexpr int BTILE = 128;    // most bins of a leaf per bin tile
constexpr int DIF_WARPS = 16;  // 8 leaves x 2 bin halves
constexpr int DIF_THREADS = 32 * DIF_WARPS;
constexpr int MPW = 2;        // most mel tiles of 8 per warp (256 mel rows)
static_assert(TFD * KCD % DIF_THREADS == 0, "whole (frame, position) items a thread");

struct DifArgs {
  const float* x;                 // [n_windows, S]
  const float* win;               // [n_fft] Hann, float32
  const float* twc;               // level l: cos(2 pi p / (n_fft >> l)) at n_fft - (n_fft >> l) + p
  const float* tws;               // the same for sin
  const __nv_bfloat16* ct;        // [bl_p, m_pad] cos(2 pi n j / m_leaf)
  const __nv_bfloat16* st;        // [bl_p, m_pad] sin
  const __nv_bfloat16* melt;      // [mel_rows, 2^L bl_p] leaf-permuted mel, transposed
  float* out;                     // [n_windows, n_mels, n_out]
  long S;
  int n_fft, m_leaf, m_pad, hop, n_out, n_tiles, nb, bl_p, mel_rows, n_mels;
  float power;
};

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void st32(__nv_bfloat16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// 16 bytes from device memory to shared memory without passing registers
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// (a, b) -> (a + b, (a - b) * conj-twiddle) in float32 without contraction,
// as _dif_tree's split_c (a real branch is the case ai = bi = 0, which
// rounds as split_r does)
__device__ __forceinline__ void dif_diff(float ar, float ai, float br, float bi, float c,
                                         float s, float& dr_out, float& di_out) {
  const float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);
  dr_out = __fadd_rn(__fmul_rn(dr, c), __fmul_rn(di, s));
  di_out = __fsub_rn(__fmul_rn(di, c), __fmul_rn(dr, s));
}

// The L-level split at leaf position n of frame f (span row f * hop): the
// 8 leaves of group g, leaf g * 8 + b in (ur[b], ui[b]).
template <int L>
__device__ __forceinline__ void dif_split(const __nv_bfloat16* span, const DifArgs& a, int f,
                                          int n, int g, float (&ur)[GROUP], float (&ui)[GROUP]) {
  constexpr int NV = 1 << L, LG = L - 3;
  float vr[NV], vi[NV];
  const __nv_bfloat16* fr = span + f * a.hop;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = n + j * a.m_leaf;
    vr[j] = __fmul_rn(__bfloat162float(fr[k]), __ldg(a.win + k));
    vi[j] = 0.f;
  }
  // the first LG levels keep only group g's branch (sum or difference)
#pragma unroll
  for (int l = 0; l < LG; ++l) {
    const int H = NV >> (l + 1);
    const bool diff = (g >> (LG - 1 - l)) & 1;
#pragma unroll
    for (int j = 0; j < NV / 2; ++j) {
      if (j < H) {
        const float ar = vr[j], ai = vi[j], br = vr[j + H], bi = vi[j + H];
        if (diff) {
          const int t = a.n_fft - (a.n_fft >> l) + n + j * a.m_leaf;
          dif_diff(ar, ai, br, bi, __ldg(a.twc + t), __ldg(a.tws + t), vr[j], vi[j]);
        } else {
          vr[j] = __fadd_rn(ar, br);
          vi[j] = __fadd_rn(ai, bi);
        }
      }
    }
  }
  // the last 3 levels in full over slots 0..7: after them slot b holds
  // leaf g * 8 + b (the sum branch first at every level)
#pragma unroll
  for (int l = LG; l < L; ++l) {
    const int H = GROUP >> (l - LG + 1);
#pragma unroll
    for (int j = 0; j < GROUP / 2; ++j) {
      if (j < H) {
        const int t = a.n_fft - (a.n_fft >> l) + n + j * a.m_leaf;
        const float c = __ldg(a.twc + t), s = __ldg(a.tws + t);
#pragma unroll
        for (int b0 = 0; b0 < GROUP; b0 += 2) {
          if (b0 % (2 * H) == 0) {
            const float ar = vr[b0 + j], ai = vi[b0 + j];
            const float br = vr[b0 + j + H], bi = vi[b0 + j + H];
            vr[b0 + j] = __fadd_rn(ar, br);
            vi[b0 + j] = __fadd_rn(ai, bi);
            dif_diff(ar, ai, br, bi, c, s, vr[b0 + j + H], vi[b0 + j + H]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < GROUP; ++b) {
    ur[b] = vr[b];
    ui[b] = vi[b];
  }
}

// grid (n_windows * n_tiles), DIF_THREADS threads: warp w takes leaf
// w % 8 of the group and half w / 8 of its bins, NTH n8 bin tiles at most
// (registers for xr and xi)
template <int L, int NTH>
__global__ void __launch_bounds__(DIF_THREADS, 1) stft_mel_dif_bf16_kernel(const DifArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LEAF_BUF = GROUP * 2 * TFD * LDD;  // bf16 of one stage of leaf chunks
  const int tbw_max = min(a.bl_p, BTILE);
  const int ldp = GROUP * tbw_max + 8;
  __nv_bfloat16* lbuf = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][GROUP][2][TFD][LDD]
  __nv_bfloat16* cbuf = lbuf + 2 * LEAF_BUF;                     // [2][2][tbw_max][LDD]
  __nv_bfloat16* pbuf = cbuf + 4 * tbw_max * LDD;                // [TFD][ldp]
  __nv_bfloat16* span = pbuf + TFD * ldp;                        // [(TFD - 1) hop + n_fft]
  float* ob = reinterpret_cast<float*>(smem);  // [TFD][mel_rows + 1], over lbuf at the end

  const int w = blockIdx.x / a.n_tiles;
  const int t0 = (blockIdx.x - w * a.n_tiles) * TFD;
  const int nf = min(TFD, a.n_out - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int lw = warp & (GROUP - 1);  // leaf of the group
  const int bh = warp / GROUP;        // bin half: tiles bh * NTH ..

  {  // the PCM span of the block's frames, rounded to bf16; zero past the last frame
    const float* xw = a.x + (long)w * a.S;
    const long s0 = (long)t0 * a.hop - a.n_fft / 2;
    const int len = (nf - 1) * a.hop + a.n_fft;
    const int span_len = (TFD - 1) * a.hop + a.n_fft;
    for (int e0 = threadIdx.x; e0 < span_len; e0 += 4 * DIF_THREADS) {
      float v[4];  // four loads in flight a thread
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * DIF_THREADS;
        const long s = s0 + e;
        v[u] = e < len && s >= 0 && s < a.S ? xw[s] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e0 + u * DIF_THREADS < span_len) span[e0 + u * DIF_THREADS] = __float2bfloat16_rn(v[u]);
    }
  }

  const int n_mt = a.mel_rows / 8;
  const long mel_ld = (long)(GROUP << (L - 3)) * a.bl_p;
  const int n_chunks = (a.m_pad + KCD - 1) / KCD;
  float mel[MPW][4];
#pragma unroll
  for (int i = 0; i < MPW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) mel[i][e] = 0.f;

  for (int grp = 0; grp < (1 << (L - 3)); ++grp) {
    const bool real_leaf = grp == 0 && lw == 0;  // leaf 0: i = 0
    for (int j0 = 0; j0 < a.bl_p; j0 += BTILE) {
      const int tbw = min(BTILE, a.bl_p - j0);     // a multiple of 16
      const int nt = min(2 * NTH, (a.nb - j0 + 7) / 8);  // n8 tiles that hold support bins

      // the split of chunk k0 into stage `st`, (frame, position) items
      // threadIdx.x, threadIdx.x + DIF_THREADS, ...
      auto split_chunk = [&](int k0, int st) {
#pragma unroll 1
       for (int i = threadIdx.x; i < TFD * KCD; i += DIF_THREADS) {
        const int f = i / KCD, nn = i - f * KCD, n = k0 + nn;
        float ur[GROUP], ui[GROUP];
        if (n < a.m_leaf) {
          dif_split<L>(span, a, f, n, grp, ur, ui);
        } else {
#pragma unroll
          for (int b = 0; b < GROUP; ++b) ur[b] = ui[b] = 0.f;
        }
        __nv_bfloat16* lb = lbuf + st * LEAF_BUF;
#pragma unroll
        for (int b = 0; b < GROUP; ++b) {
          lb[((2 * b) * TFD + f) * LDD + nn] = __float2bfloat16_rn(ur[b]);
          lb[((2 * b + 1) * TFD + f) * LDD + nn] = __float2bfloat16_rn(ui[b]);
        }
       }
      };
      // the C and S chunks of bins j0 .. j0 + tbw into stage `st`, copied
      // asynchronously (cp_async_wait_all before the next barrier)
      auto stage_cs = [&](int k0, int st) {
        const int kc = min(KCD, a.m_pad - k0);
        __nv_bfloat16* cb = cbuf + st * 2 * tbw_max * LDD;
        for (int i = threadIdx.x; i < tbw * (KCD / 8); i += DIF_THREADS) {
          const int r = i / (KCD / 8);
          const int c = (i - r * (KCD / 8)) * 8;
          if (c < kc) {
            const long src = (long)(j0 + r) * a.m_pad + k0 + c;
            cp_async16(cb + r * LDD + c, a.ct + src);
            cp_async16(cb + (tbw_max + r) * LDD + c, a.st + src);
          }
        }
      };

      float xr[NTH][4], xi[NTH][4];
#pragma unroll
      for (int jt = 0; jt < NTH; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) xr[jt][e] = xi[jt][e] = 0.f;

      // two stages: the products of chunk c overlap the split of chunk c + 1
      __syncthreads();  // the span is staged; the last pass is done with stage 0
      stage_cs(0, 0);
      split_chunk(0, 0);
      cp_async_wait_all();
      for (int c = 0; c < n_chunks; ++c) {
        __syncthreads();  // chunk c is staged; every warp is done with chunk c - 1
        const int st = c & 1, kc = min(KCD, a.m_pad - c * KCD);
        if (c + 1 < n_chunks) stage_cs((c + 1) * KCD, st ^ 1);  // in flight during the products
        const __nv_bfloat16* lb = lbuf + st * LEAF_BUF;
        const __nv_bfloat16* cb = cbuf + st * 2 * tbw_max * LDD;
        for (int ks = 0; ks < kc; ks += 16) {
          const __nv_bfloat16* ap = lb + ((2 * lw) * TFD + g) * LDD + ks + tq * 2;
          const __nv_bfloat16* aq = ap + TFD * LDD;
          uint32_t ar[4], ai[4], nr[4];
          ar[0] = ld32(ap);
          ar[1] = ld32(ap + 8 * LDD);
          ar[2] = ld32(ap + 8);
          ar[3] = ld32(ap + 8 * LDD + 8);
          ai[0] = ld32(aq);
          ai[1] = ld32(aq + 8 * LDD);
          ai[2] = ld32(aq + 8);
          ai[3] = ld32(aq + 8 * LDD + 8);
#pragma unroll
          for (int e = 0; e < 4; ++e) nr[e] = ar[e] ^ 0x80008000u;  // -r, exact
#pragma unroll
          for (int jt = 0; jt < NTH; ++jt) {
            const int jg = bh * NTH + jt;
            if (jg < nt) {
              const __nv_bfloat16* bc = cb + (jg * 8 + g) * LDD + ks + tq * 2;
              const __nv_bfloat16* bs = bc + tbw_max * LDD;
              const uint32_t c0 = ld32(bc), c1 = ld32(bc + 8);
              const uint32_t s0 = ld32(bs), s1 = ld32(bs + 8);
              mma_bf16(xr[jt], ar, c0, c1);
              mma_bf16(xi[jt], nr, s0, s1);
              if (!real_leaf) {
                mma_bf16(xr[jt], ai, s0, s1);
                mma_bf16(xi[jt], ai, c0, c1);
              }
            }
          }
        }
        if (c + 1 < n_chunks) split_chunk((c + 1) * KCD, st ^ 1);
        cp_async_wait_all();
      }

      // |X|^power -> bf16 into this warp's tiles of its leaf's columns of the
      // p tile (tiles past the support hold zeros and are written too)
#pragma unroll
      for (int jt = 0; jt < NTH; ++jt) {
        const int jg = bh * NTH + jt;
        if (jg * 8 < tbw) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float r = xr[jt][e], q = xi[jt][e];
            p[e] = power_of(__fadd_rn(__fmul_rn(r, r), __fmul_rn(q, q)), a.power);
          }
          __nv_bfloat16* pp = pbuf + g * ldp + lw * tbw + jg * 8 + tq * 2;
          st32(pp, pack_bf16(p[0], p[1]));
          st32(pp + 8 * ldp, pack_bf16(p[2], p[3]));
        }
      }
      __syncthreads();

      // the mel product over the group's leaves: p [16 x 8 tbw] x M, mel
      // tiles warp, warp + 16 (the next pass writes the p tile only after
      // its K loop's barriers)
#pragma unroll 8
      for (int kk = 0; kk < GROUP * tbw; kk += 16) {
        const int lk = kk / tbw;
        const __nv_bfloat16* ap = pbuf + g * ldp + kk + tq * 2;
        uint32_t pa[4];
        pa[0] = ld32(ap);
        pa[1] = ld32(ap + 8 * ldp);
        pa[2] = ld32(ap + 8);
        pa[3] = ld32(ap + 8 * ldp + 8);
        const long col = (long)(grp * GROUP + lk) * a.bl_p + j0 + (kk - lk * tbw) + tq * 2;
#pragma unroll
        for (int i = 0; i < MPW; ++i) {
          const int mt = warp + DIF_WARPS * i;
          if (mt < n_mt) {
            const __nv_bfloat16* bp = a.melt + (long)(mt * 8 + g) * mel_ld + col;
            mma_bf16(mel[i], pa, ldg32(bp), ldg32(bp + 8));
          }
        }
      }
    }
  }

  __syncthreads();  // the leaf buffers become the output tile
  const int ldo = a.mel_rows + 1;
#pragma unroll
  for (int i = 0; i < MPW; ++i) {
    const int mt = warp + DIF_WARPS * i;
    if (mt < n_mt) {
      const int col = mt * 8 + tq * 2;
      ob[g * ldo + col] = mel[i][0];
      ob[g * ldo + col + 1] = mel[i][1];
      ob[(g + 8) * ldo + col] = mel[i][2];
      ob[(g + 8) * ldo + col + 1] = mel[i][3];
    }
  }
  __syncthreads();
  float* ow = a.out + (long)w * a.n_mels * a.n_out + t0;
  for (int i = threadIdx.x; i < a.n_mels * TFD; i += DIF_THREADS) {
    const int m = i / TFD;
    const int f = i - m * TFD;
    if (f < nf) ow[(long)m * a.n_out + f] = ob[f * ldo + m];
  }
}

size_t dif_smem_bytes(int hop, int n_fft, int bl_p) {
  const size_t tbw = bl_p < BTILE ? bl_p : BTILE;
  const size_t span = ((size_t)(TFD - 1) * hop + n_fft + 7) / 8 * 8;
  return sizeof(__nv_bfloat16) *
         (2 * (size_t)GROUP * 2 * TFD * LDD + 4 * tbw * LDD + TFD * (GROUP * tbw + 8) + span);
}

template <int L, int NTH>
cudaError_t launch_dif(int n_blocks, cudaStream_t st, const DifArgs& a) {
  const size_t smem = dif_smem_bytes(a.hop, a.n_fft, a.bl_p);
  const cudaError_t err = allow_smem((const void*)stft_mel_dif_bf16_kernel<L, NTH>, smem);
  if (err != cudaSuccess) return err;
  stft_mel_dif_bf16_kernel<L, NTH><<<n_blocks, DIF_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_dif_l(int n_blocks, cudaStream_t st, const DifArgs& a) {
  // registers for xr and xi: 5 n8 tiles a warp up to 80 bins a leaf, else 8
  return a.bl_p <= 80 ? launch_dif<L, 5>(n_blocks, st, a) : launch_dif<L, 8>(n_blocks, st, a);
}

}  // namespace

extern "C" {

// The direct route. x [n_windows, S] float32; wr, wi [bins_p, k_pad] bf16
// (Hann-folded cos and -sin, zero past n_fft and past the mel support);
// melt [mel_rows, bins_p] bf16 (the mel matrix transposed, zero rows past
// n_mels); out [n_windows, n_mels, n_out] float32 holds the first n_out
// frames of each window. k_pad and bins_p multiples of 64; mel_rows one of
// 64, 128, 160, 256. With P = 8 / gcd(hop, 8) frame classes (direct_item)
// and n_tiles = ceil(ceil(n_out / P) / 128), xb [n_windows, P, lrow] bf16 is
// the pre-pass's workspace, lrow a multiple of 8, at least (P n_tiles 128 -
// 1) hop + n_fft, so that every frame of every tile lies in its row. sms:
// the device's SMs, the persistent grid. Returns cudaErrorNotSupported
// where cuTensorMapEncodeTiled refuses a tensor map.
int aat_stft_mel_bf16(const void* x, const void* wr, const void* wi, const void* melt, void* xb,
                      void* out, int n_windows, long S, int n_fft, int k_pad, int hop, int n_out,
                      int bins_p, int mel_rows, int n_mels, float power, long lrow, int sms,
                      void* stream) {
  if (n_windows <= 0 || n_out <= 0) return 0;
  int shift = 8;
  while (hop > 0 && hop % shift) shift /= 2;  // gcd(hop, 8)
  const int classes = 8 / shift;
  const long n_u = ((long)n_out + classes - 1) / classes;
  const long n_tiles = (n_u + DF - 1) / DF;
  const long n_items = (long)n_windows * classes * n_tiles;
  if (k_pad % DK || bins_p % DB || bins_p <= 0 || k_pad < n_fft || n_fft <= 0 ||
      n_mels > mel_rows || hop <= 0 || lrow % 8 || sms <= 0 ||
      lrow < ((long)classes * n_tiles * DF - 1) * hop + n_fft || n_items > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  DirectArgs a;
  a.out = (float*)out;
  a.classes = classes;
  a.shift = shift;
  a.n_out = n_out;
  a.hop = hop;
  a.n_tiles = (int)n_tiles;
  a.n_items = (int)n_items;
  a.n_chunks = k_pad / DK;
  a.n_passes = bins_p / DB;
  a.n_mels = n_mels;
  a.power = power;
  const cudaStream_t st = (cudaStream_t)stream;

  const long lfill = (((long)n_out - 1) * hop + n_fft + 7) / 8 * 8;
  const long pairs = (long)n_windows * classes * (lfill / 2);
  const long want = (pairs + 255) / 256, most = 8L * sms;
  direct_frames_kernel<<<(int)(want < most ? want : most), 256, 0, st>>>(
      (const float*)x, (__nv_bfloat16*)xb, n_windows * classes, classes, shift, S, lrow, lfill,
      n_fft / 2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap mx, mr, mi, mm;
  const cuuint64_t dft_dims[2] = {(cuuint64_t)k_pad, (cuuint64_t)bins_p};
  const cuuint64_t dft_stride[1] = {(cuuint64_t)k_pad * 2};
  const cuuint32_t dft_box[2] = {DK, DB};
  const cuuint64_t mel_dims[2] = {(cuuint64_t)bins_p, (cuuint64_t)mel_rows};
  const cuuint64_t mel_stride[1] = {(cuuint64_t)bins_p * 2};
  const cuuint32_t mel_box[2] = {DB, (cuuint32_t)mel_rows};
  // a class's frames: sample k (< n_fft; the rest reads as zeros) of the
  // u-th frame from 8-sample block b of copy row r is element r lrow + 8 b +
  // u P hop + k of xb
  const cuuint64_t x_dims[4] = {(cuuint64_t)n_fft, (cuuint64_t)lrow / 8, (cuuint64_t)DF,
                                (cuuint64_t)n_windows * classes};
  const cuuint64_t x_stride[3] = {16, (cuuint64_t)classes * hop * 2, (cuuint64_t)lrow * 2};
  const cuuint32_t x_box[4] = {DK, 1, DF, 1};
  if (!encode_bf16(&mr, wr, 2, dft_dims, dft_stride, dft_box) ||
      !encode_bf16(&mi, wi, 2, dft_dims, dft_stride, dft_box) ||
      !encode_bf16(&mm, melt, 2, mel_dims, mel_stride, mel_box) ||
      !encode_bf16(&mx, xb, 4, x_dims, x_stride, x_box))
    return (int)cudaErrorNotSupported;
  switch (mel_rows) {
    case 64: return (int)launch_direct<64>(mx, mr, mi, mm, a, sms, st);
    case 128: return (int)launch_direct<128>(mx, mr, mi, mm, a, sms, st);
    case 160: return (int)launch_direct<160>(mx, mr, mi, mm, a, sms, st);
    case 256: return (int)launch_direct<256>(mx, mr, mi, mm, a, sms, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared memory of one block of the direct route, in bytes, for mel_rows
// (ops/melspec.py :: direct_smem sizes it the same).
int aat_stft_mel_bf16_smem(int mel_rows) { return (int)direct_smem(mel_rows); }

// The dif route. x [n_windows, S] float32; win [n_fft] float32; twc, tws
// [n_fft - (n_fft >> levels)] float32 (the levels' twiddle tables, end to
// end); ct, st [bl_p, m_pad] bf16
// (the leaf DFT matrices, transposed: row j = bin j of a leaf, zero past
// m_leaf = n_fft >> levels and past nb); melt [mel_rows, 2^levels bl_p]
// bf16 (the leaf-permuted mel matrix, transposed, zero rows past n_mels);
// out [n_windows, n_mels, n_out] float32. levels 3..5; m_pad a multiple of
// 16; bl_p a multiple of 16 up to 128, else of 128; mel_rows a multiple of
// 8 up to 256.
int aat_stft_mel_dif_bf16(const void* x, const void* win, const void* twc, const void* tws,
                          const void* ct, const void* st, const void* melt, void* out,
                          int n_windows, long S, int n_fft, int levels, int m_pad, int hop,
                          int n_out, int nb, int bl_p, int mel_rows, int n_mels, float power,
                          void* stream) {
  if (n_windows <= 0 || n_out <= 0) return 0;
  if (levels < 3 || levels > 5 || n_fft % (1 << levels) || m_pad % 16 ||
      m_pad < (n_fft >> levels) || bl_p % 16 || bl_p <= 0 || (bl_p > BTILE && bl_p % BTILE) ||
      nb > bl_p || nb <= 0 || mel_rows % 8 || mel_rows > 8 * DIF_WARPS * MPW || n_mels > mel_rows ||
      hop <= 0)
    return (int)cudaErrorInvalidValue;
  DifArgs a;
  a.x = (const float*)x;
  a.win = (const float*)win;
  a.twc = (const float*)twc;
  a.tws = (const float*)tws;
  a.ct = (const __nv_bfloat16*)ct;
  a.st = (const __nv_bfloat16*)st;
  a.melt = (const __nv_bfloat16*)melt;
  a.out = (float*)out;
  a.S = S;
  a.n_fft = n_fft;
  a.m_leaf = n_fft >> levels;
  a.m_pad = m_pad;
  a.hop = hop;
  a.n_out = n_out;
  a.n_tiles = (n_out + TFD - 1) / TFD;
  a.nb = nb;
  a.bl_p = bl_p;
  a.mel_rows = mel_rows;
  a.n_mels = n_mels;
  a.power = power;
  if ((long)n_windows * a.n_tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const int n_blocks = n_windows * a.n_tiles;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (levels) {
    case 3: return (int)launch_dif_l<3>(n_blocks, s, a);
    case 4: return (int)launch_dif_l<4>(n_blocks, s, a);
    default: return (int)launch_dif_l<5>(n_blocks, s, a);
  }
}

}  // extern "C"
