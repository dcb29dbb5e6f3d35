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
// the bf16 leaf matrices C = cos, S = sin [bl_p, m_pad] with float32 sums:
// xr = C.r + S.i, xi = C.i - S.r; p = |X|^power in float32 (|X|^2 rounded
// step by step; the square root, or any other power, on the hardware's
// approximate units, within a few float32 ulps), rounded to bf16, times the
// leaf-permuted mel rows (bf16), summed in float32. The split uses
// explicitly rounded float32 products and sums (no fused multiply-add) so
// its leaves equal the plain version's bit for bit.
//
// What bounds it: as a function, the bytes (the float32 PCM read once, the
// output written once) at the main path's shapes. Its tensor-core work is
// (2 + 4 (2^L - 1)) m_leaf bl products a frame: 3.9 MFLOP at classify
// (n_fft 4096, L 3, bl 128) and 3.0 at the end-scan (4800, L 4, bl 80), a
// quarter of the direct route's; the float32 split is ~90 k operations and
// ~80 loads and stores a frame at the end-scan, more time than the
// tensor-core work. The tree yields the 8 leaves of a group from the same 8
// samples, so their accumulators stay live across the whole K loop: with
// frames as the wgmma's 64 rows they would take twice the register file.
// So the bins are M and (leaf, frame) is N:
//
//  - a work item is (window, 16 consecutive frames); persistent blocks of
//    four warpgroups, one an SM, walk over the items;
//  - two consumer warpgroups (setmaxnreg 184) take bins 0..63 and 64..127
//    of a pass over a leaf group's bins (at most 128 a pass). Per k16 step
//    four wgmma m64n128k16, A = the C or S rows (K-major, by TMA), B = the
//    group's leaves [(leaf, frame) 128 x 16] (K-major): xr += C.R, xr +=
//    S.I, xi += C.I, xi += (-S).R (the wgmma's scale-a of -1 is exact);
//    leaf 0's imaginary part is zero and adds exact zeros. At the
//    end-scan's 80 bins a leaf the second warpgroup's rows 80..127 are
//    wasted work (M is 64 rows);
//  - a ring of `stages` stages (3 where shared memory holds them, else 2,
//    else 1), each a K chunk of 64 leaf positions: the pass's [tbw x 64]
//    of C and of S by TMA (128-byte swizzle; a warpgroup's rows past tbw
//    read the next tile and are never stored) and the group's real and
//    imaginary leaves [128 x 64], which the split warpgroups write in the
//    same swizzled layout. A stage's full barrier takes the TMA bytes and
//    each split warp's arrival, its empty barrier each consumer warp's
//    once its products are done (the consumers' waits back off, leaving
//    the issue slots to the split): the split of chunk c + 1 runs while
//    the consumers' wgmma run on chunk c, with no block-wide barrier (with
//    one stage the consumers free it as soon as their products are done);
//  - two split warpgroups (setmaxnreg 72; with one warp a scheduler the
//    split is latency-bound) run dif_split at one position of two frames
//    a lane, the frames sharing each window and twiddle load (a warp
//    covers 32 positions of a frame's row: no bank conflicts), from the
//    item's bf16 span; one of their threads starts each stage's C/S loads;
//  - the consumers also stage each item's span, (16 - 1) hop + n_fft
//    samples rounded to bf16, 16 bytes a load, into one of `spans` buffers
//    (2: the next item's at the start of an item; or 1: at its end), which
//    the split frees once it is done with the item;
//  - after a pass each consumer thread computes p from its accumulators
//    and stores it as bf16 into a [leaf, bin, frame] tile; the mel product
//    then runs on the CUDA cores over each mel row's nonzero bins only. At
//    block start the consumer warps scan melt, a warp a row, for each
//    row's band [lo, hi] of bins with a nonzero weight (the filters are
//    triangles some tens of bins wide) and copy the bands' weights into a
//    list in shared memory; thread (row, 4 frames) adds w . p over the
//    band's bins of the pass's leaf group and bin tile in bin order (a
//    product of two bf16 values is exact in float32, so fmaf rounds once,
//    as a separate add would). A dense mel product on the tensor cores
//    would fetch the [mel_rows x 2^L bl_p] matrix (~0.3 MB, more than C and
//    S) from L2 for every 16 frames, to multiply mostly zeros. Where the
//    list does not fit beside one ring stage and one span buffer (n_fft
//    32768 at 7 levels and more) the launcher leaves it out and the mel
//    passes read the band's weights from melt (L2);
//  - the split's depth L runs from 3 to 8 (n_fft up to 32768, leaves of
//    at least 128 points): the first L - 3 levels keep one group's branch
//    of 2^L samples a frame in registers, which spill to local memory from
//    L = 5 on (the split warps hold 72 registers); a deep split is right
//    and slow;
//  - the item's [n_mels x 16] outputs are summed in registers across leaf
//    groups and bin tiles and stored from them.
// Every output element is summed by one thread in one fixed order, with no
// atomics, so two launches agree bit for bit; an all-zero frame gives exact
// zeros (no sum mixes frames); rows past n_out are never stored; offsets
// into a window are 64-bit. A mel row whose weights are all zero gives 0
// even where p is not finite. A wait on a barrier that never completes
// traps (after ~2^34 clocks) rather than hang the process. Where its time
// goes: chip_dif_breakdown.py.

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

// wait until the phase of parity `parity` has completed; a waiter that is
// not on the critical path sleeps `sleep_ns` between tries, leaving the
// issue slots to the warps that are
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity, int sleep_ns = 0) {
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
    if (sleep_ns) __nanosleep(sleep_ns);
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

// d[0..64) += SA A[64 x 16] . B[128 x 16]^T, both from shared memory
// (K-major, 128-byte swizzle; SA = 1 or -1); scale_d 0 overwrites d instead
template <int SA>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, %67, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d), "n"(SA));
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
            wgmma_m64n128k16_ss<1>(acc, da + 2 * ks, db + 2 * ks, c > 0 || ks > 0);
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

constexpr int FD = 16;                // frames a work item
constexpr int GROUP = 8;              // leaves a group: N = GROUP x FD = 128 columns
constexpr int KD = 64;                // leaf positions a K chunk: a 128-byte row of bf16
constexpr int BTILE = 128;            // most bins of a leaf a pass: 64 a consumer warpgroup
constexpr int DIF_THREADS = 512;      // consumers 0, 1 (and span loaders); split 2, 3
constexpr int DIF_STAGES_MAX = 3;     // ring stages
constexpr int LEAF_TILE = GROUP * FD * KD * 2;  // a stage's R (or I) [(leaf, frame) x 64] bf16
constexpr int MEL_MAX = 256;          // most mel rows
constexpr int SPAN_LOADERS = 256;     // the consumer threads
constexpr int SPAN_INFLIGHT = 8;      // 16-byte span loads in flight a loader
constexpr int SCAN_ROWS = 4;          // mel rows a consumer warp scans at once
constexpr int LIST_INFLIGHT = 4;      // band-list weights in flight a consumer
static_assert(GROUP * FD == 128, "wgmma N = 128 (leaf, frame) columns");

struct DifArgs {
  const float* x;             // [n_windows, S]
  const float* win;           // [n_fft] Hann, float32
  const float* twc;           // level l: cos(2 pi p / (n_fft >> l)) at n_fft - (n_fft >> l) + p
  const float* tws;           // the same for sin
  const __nv_bfloat16* melt;  // [mel_rows, 2^L bl_p] leaf-permuted mel, transposed
  float* out;                 // [n_windows, n_mels, n_out]
  long S;
  int n_fft, m_leaf, hop, n_out, n_tiles, n_items, n_chunks, bl_p, tbw, n_bt, n_mels;
  int stages, spans, span_alloc;  // ring stages, span buffers, bf16 elements a span buffer
  int band_cap;                   // mel weights the band list holds
  float power;
};

__device__ __forceinline__ void sts16(unsigned char* p, __nv_bfloat16 v) {
  *reinterpret_cast<__nv_bfloat16*>(p) = v;
}

__device__ __forceinline__ void named_bar(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// order this thread's shared-memory writes before later wgmma reads of them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }

// The hardware square root, for |X|^1 (within an ulp of the rounded one,
// far below the bf16 rounding that follows).
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// x^y as 2^(y log2 x) on the hardware's approximate units, for |X|^power
// at a power other than 1 and 2 (a few float32 ulps, far below the bf16
// rounding that follows; 0 stays 0)
__device__ __forceinline__ float pow_approx(float x, float y) {
  float r;
  asm("lg2.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  r *= y;
  asm("ex2.approx.f32 %0, %0;" : "+f"(r));
  return r;
}
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// (a, b) -> (a + b, (a - b) * conj-twiddle) in float32 without contraction,
// as _dif_tree's split_c (a real branch is the case ai = bi = 0, which
// rounds as split_r does)
__device__ __forceinline__ void dif_diff(float ar, float ai, float br, float bi, float c,
                                         float s, float& dr_out, float& di_out) {
  const float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);
  dr_out = __fadd_rn(__fmul_rn(dr, c), __fmul_rn(di, s));
  di_out = __fsub_rn(__fmul_rn(di, c), __fmul_rn(dr, s));
}

// The L-level split at leaf position n of NF frames f + 8 i (span rows
// (f + 8 i) hop): the 8 leaves of group g, leaf g * 8 + b of frame f + 8 i
// in (ur[i][b], ui[i][b]); zeros for n past the leaf. The frames share
// each window and twiddle load.
template <int L, int NF>
__device__ __forceinline__ void dif_split(const __nv_bfloat16* span, const DifArgs& a, int f,
                                          int n, int g, float (&ur)[NF][GROUP],
                                          float (&ui)[NF][GROUP]) {
  constexpr int NV = 1 << L, LG = L - 3;
  if (n >= a.m_leaf) {
#pragma unroll
    for (int i = 0; i < NF; ++i)
#pragma unroll
      for (int b = 0; b < GROUP; ++b) ur[i][b] = ui[i][b] = 0.f;
    return;
  }
  float vr[NF][NV], vi[NF][NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = n + j * a.m_leaf;
    const float w = __ldg(a.win + k);
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      vr[i][j] = __fmul_rn(__bfloat162float(span[(f + 8 * i) * a.hop + k]), w);
      vi[i][j] = 0.f;
    }
  }
  // the first LG levels keep only group g's branch (sum or difference)
#pragma unroll
  for (int l = 0; l < LG; ++l) {
    const int H = NV >> (l + 1);
    const bool diff = (g >> (LG - 1 - l)) & 1;
#pragma unroll
    for (int j = 0; j < NV / 2; ++j) {
      if (j < H) {
        if (diff) {
          const int t = a.n_fft - (a.n_fft >> l) + n + j * a.m_leaf;
          const float c = __ldg(a.twc + t), s = __ldg(a.tws + t);
#pragma unroll
          for (int i = 0; i < NF; ++i)
            dif_diff(vr[i][j], vi[i][j], vr[i][j + H], vi[i][j + H], c, s, vr[i][j], vi[i][j]);
        } else {
#pragma unroll
          for (int i = 0; i < NF; ++i) {
            vr[i][j] = __fadd_rn(vr[i][j], vr[i][j + H]);
            vi[i][j] = __fadd_rn(vi[i][j], vi[i][j + H]);
          }
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
#pragma unroll
            for (int i = 0; i < NF; ++i) {
              const float ar = vr[i][b0 + j], ai = vi[i][b0 + j];
              const float br = vr[i][b0 + j + H], bi = vi[i][b0 + j + H];
              vr[i][b0 + j] = __fadd_rn(ar, br);
              vi[i][b0 + j] = __fadd_rn(ai, bi);
              dif_diff(ar, ai, br, bi, c, s, vr[i][b0 + j + H], vi[i][b0 + j + H]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NF; ++i)
#pragma unroll
    for (int b = 0; b < GROUP; ++b) {
      ur[i][b] = vr[i][b];
      ui[i][b] = vi[i][b];
    }
}

// Work item `item`: window w, frames t0 .. t0 + 15.
__device__ __forceinline__ void dif_item(const DifArgs& a, int item, int& w, int& t0) {
  w = item / a.n_tiles;
  t0 = (item - w * a.n_tiles) * FD;
}

// Where an item's span starts in its buffer: sample e of the span (window
// element t0 hop - n_fft/2 + e) is element delta + e, delta the span start's
// address in floats mod 4, so that 16-byte runs of the window are 8-byte
// runs of the buffer.
__device__ __forceinline__ int dif_delta(const DifArgs& a, int w, int t0) {
  const long s0 = (long)t0 * a.hop - a.n_fft / 2;
  return (int)(((long)(reinterpret_cast<uintptr_t>(a.x) >> 2) + (long)w * a.S + s0) & 3);
}

// Span loader lt (a consumer thread) stages the item's span into sp: zeros
// outside the window and past the item's last frame.
__device__ __forceinline__ void dif_load_span(const DifArgs& a, int w, int t0,
                                              __nv_bfloat16* sp, int lt) {
  const long s0 = (long)t0 * a.hop - a.n_fft / 2;
  const float* xs = a.x + (long)w * a.S + s0;  // sample e of the span at xs[e]
  // the span's samples inside the window and up to its last frame: e_lo .. e_hi - 1
  const int e_lo = s0 < 0 ? (int)-s0 : 0;
  const int e_hi = (int)min((long)(min(FD, a.n_out - t0) - 1) * a.hop + a.n_fft, a.S - s0);
  const int delta = dif_delta(a, w, t0);
  const int quads = a.span_alloc / 4;
  for (int q0 = lt; q0 < quads; q0 += SPAN_INFLIGHT * SPAN_LOADERS) {
    float4 v[SPAN_INFLIGHT];  // 16-byte loads in flight a thread
#pragma unroll
    for (int u = 0; u < SPAN_INFLIGHT; ++u) {
      const int e = 4 * (q0 + u * SPAN_LOADERS) - delta;
      if (e >= e_lo && e + 4 <= e_hi) {
        v[u] = __ldcs(reinterpret_cast<const float4*>(xs + e));
      } else {
        float t[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) t[i] = e + i >= e_lo && e + i < e_hi ? xs[e + i] : 0.f;
        v[u] = make_float4(t[0], t[1], t[2], t[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < SPAN_INFLIGHT; ++u) {
      const int q = q0 + u * SPAN_LOADERS;
      const float4 t = v[u];
      if (q < quads)
        *reinterpret_cast<uint2*>(sp + 4 * q) = make_uint2(pack_bf16(t.x, t.y), pack_bf16(t.z, t.w));
    }
  }
}

// The band of each mel row m < n_mels: lo[m] .. hi[m], the bins whose
// weight is not zero (hi[m] = -1 where none is). Consumer warp cw of 8
// takes rows cw, cw + 8, ..., SCAN_ROWS at a time (their 8-column runs
// spread over the lanes, SCAN_ROWS * 4 loads in flight a lane), and
// reduces each row's first and last bin over its lanes.
template <int L>
__device__ __forceinline__ void dif_mel_band(const DifArgs& a, int* lo, int* hi, int ct) {
  const int cw = ct >> 5, lane = ct & 31;
  const int c8 = (GROUP << (L - 3)) * a.bl_p / 8;  // 8-column runs a row
  const uint4* m8 = reinterpret_cast<const uint4*>(a.melt);
  for (int m0 = cw; m0 < a.n_mels; m0 += 8 * SCAN_ROWS) {
    int bmin[SCAN_ROWS], bmax[SCAN_ROWS];
#pragma unroll
    for (int q = 0; q < SCAN_ROWS; ++q) bmin[q] = 0x7fffffff, bmax[q] = -1;
    for (int r0 = lane; r0 < c8; r0 += 32 * 4) {
      uint4 v[SCAN_ROWS][4];
#pragma unroll
      for (int q = 0; q < SCAN_ROWS; ++q)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int m = m0 + 8 * q, r = r0 + 32 * u;
          v[q][u] = m < a.n_mels && r < c8 ? __ldcs(m8 + (long)m * c8 + r) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
      for (int q = 0; q < SCAN_ROWS; ++q)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint32_t word[4] = {v[q][u].x, v[q][u].y, v[q][u].z, v[q][u].w};
          if (!((word[0] | word[1] | word[2] | word[3]) & 0x7fff7fffu)) continue;
          for (int h = 0; h < 8; ++h) {
            if ((word[h >> 1] >> (16 * (h & 1))) & 0x7fff) {
              const int col = (r0 + 32 * u) * 8 + h, leaf = col / a.bl_p;
              const int bin = ((col - leaf * a.bl_p) << L) | (int)(__brev(leaf) >> (32 - L));
              bmin[q] = min(bmin[q], bin);
              bmax[q] = max(bmax[q], bin);
            }
          }
        }
    }
#pragma unroll
    for (int q = 0; q < SCAN_ROWS; ++q) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        bmin[q] = min(bmin[q], __shfl_xor_sync(0xffffffffu, bmin[q], d));
        bmax[q] = max(bmax[q], __shfl_xor_sync(0xffffffffu, bmax[q], d));
      }
      if (lane == 0 && m0 + 8 * q < a.n_mels) {
        lo[m0 + 8 * q] = bmin[q];
        hi[m0 + 8 * q] = bmax[q];
      }
    }
  }
}

// Each row's band weights in bin order, into the band list; the bands
// packed, lo[m] = lo | hi << 16 (-1 where none), hi[m] the row's offset in
// the list and hi[n_mels] its length (where that exceeds band_cap the mel
// passes read melt instead); consumer thread ct of 256, between barriers.
// The entries are spread over the threads, LIST_INFLIGHT loads in flight
// each.
template <int L>
__device__ __forceinline__ void dif_band_list(const DifArgs& a, int* lo, int* hi,
                                              unsigned short* wband, int ct) {
  if (ct < 32) {  // lo[m] becomes lo | hi << 16 (-1: no band), hi[m] the row's list offset
    const int per = (a.n_mels + 31) / 32, m0 = ct * per;  // lane ct's rows, in order
    int width[MEL_MAX / 32], sum = 0;
#pragma unroll
    for (int i = 0; i < MEL_MAX / 32; ++i) {
      const int m = m0 + i;
      width[i] = i < per && m < a.n_mels && hi[m] >= 0 ? hi[m] - lo[m] + 1 : 0;
      sum += width[i];
    }
    int incl = sum;  // inclusive scan of the lanes' sums
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (ct >= d) incl += up;
    }
    int o = incl - sum;
#pragma unroll
    for (int i = 0; i < MEL_MAX / 32; ++i) {
      const int m = m0 + i;
      if (i < per && m < a.n_mels) {
        lo[m] = width[i] ? lo[m] | hi[m] << 16 : -1;
        hi[m] = o;
        o += width[i];
      }
    }
    if (ct == 31) hi[a.n_mels] = incl;
  }
  named_bar(1, 256);
  const int* woff = hi;
  const int total = woff[a.n_mels];
  if (total > a.band_cap) return;
  const unsigned short* m16 = reinterpret_cast<const unsigned short*>(a.melt);
  const int mel_cols = (GROUP << (L - 3)) * a.bl_p;
  for (int e0 = ct; e0 < total; e0 += LIST_INFLIGHT * 256) {
    unsigned short v[LIST_INFLIGHT];
#pragma unroll
    for (int u = 0; u < LIST_INFLIGHT; ++u) {
      const int e = e0 + u * 256;
      v[u] = 0;
      if (e < total) {
        int m0 = 0, m1 = a.n_mels;  // the row: the last m with woff[m] <= e
        while (m1 - m0 > 1) {
          const int mid = (m0 + m1) >> 1;
          if (woff[mid] <= e) m0 = mid; else m1 = mid;
        }
        const int bin = (lo[m0] & 0xffff) + e - woff[m0];
        const int leaf = (int)(__brev(bin & ((1 << L) - 1)) >> (32 - L));
        v[u] = __ldcs(m16 + (long)m0 * mel_cols + leaf * a.bl_p + (bin >> L));
      }
    }
#pragma unroll
    for (int u = 0; u < LIST_INFLIGHT; ++u)
      if (e0 + u * 256 < total) wband[e0 + u * 256] = v[u];
  }
}

// The mel bands and the band list at block start, out of line: its
// registers and code stay out of the consumers' loop.
template <int L>
__device__ __noinline__ void dif_bands(const DifArgs& a, int* lo, int* hi, unsigned short* wband,
                                       int ct) {
  dif_mel_band<L>(a, lo, hi, ct);
  named_bar(1, 256);
  dif_band_list<L>(a, lo, hi, wband, ct);
  named_bar(1, 256);
}

// The mel rows over one pass's p tile (leaf group grp, bins j0 .. j0 + tbw
// of each leaf): thread ct takes rows ct / 4 + 64 r and frames 4 (ct % 4)
// .. + 3, and adds w . p over the row's band in bin order.
template <int L>
__device__ __forceinline__ void dif_mel_pass(const DifArgs& a, const int* lo, const int* woff,
                                             const unsigned short* wband,
                                             const __nv_bfloat16* ptile, int grp, int j0, int ct,
                                             float (&mel)[4][4]) {
  constexpr int R = L - 3;  // a bin's leaf is in group grp iff bin % 2^R == bitrev_R(grp)
  int res = 0;
  if constexpr (R > 0) res = (int)(__brev(grp) >> (32 - R));
  const int mel_cols = (GROUP << R) * a.bl_p;
  const int b_lo = j0 << L, b_hi = ((j0 + a.tbw) << L) - 1;
  const bool listed = woff[a.n_mels] <= a.band_cap;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = (ct >> 2) + 64 * r;
    const int band = m < a.n_mels ? lo[m] : -1;
    if (band >= 0) {
      int b0 = max(band & 0xffff, b_lo);
      const int b1 = min(band >> 16, b_hi);
      b0 += (res - b0) & ((1 << R) - 1);
      const unsigned short* row =
          reinterpret_cast<const unsigned short*>(a.melt) + (long)m * mel_cols;
      const unsigned short* wl = wband + woff[m] - (band & 0xffff);
#pragma unroll 2
      for (int bin = b0; bin <= b1; bin += 1 << R) {
        const int leaf = (int)(__brev(bin & ((1 << L) - 1)) >> (32 - L));
        const int j = (bin >> L) - j0;
        const uint32_t w16 = listed ? wl[bin] : __ldg(row + leaf * a.bl_p + j0 + j);
        const float wv = __uint_as_float(w16 << 16);
        const uint2 pv = *reinterpret_cast<const uint2*>(
            ptile + ((leaf & (GROUP - 1)) * a.tbw + j) * FD + 4 * (ct & 3));
        mel[r][0] = fmaf(wv, bf16_lo(pv.x), mel[r][0]);
        mel[r][1] = fmaf(wv, bf16_hi(pv.x), mel[r][1]);
        mel[r][2] = fmaf(wv, bf16_lo(pv.y), mel[r][2]);
        mel[r][3] = fmaf(wv, bf16_hi(pv.y), mel[r][3]);
      }
    }
  }
}

// Persistent: block b takes work items b, b + gridDim.x, ... (dif_item).
template <int L>
__global__ void __launch_bounds__(DIF_THREADS, 1)
stft_mel_dif_bf16_kernel(const __grid_constant__ CUtensorMap map_c,
                         const __grid_constant__ CUtensorMap map_s, const DifArgs a) {
  constexpr int NG = 1 << (L - 3);  // leaf groups
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int cs_bytes = a.tbw * KD * 2;  // a stage's C (or S): [tbw bins x 64] bf16
  const int stage_bytes = 2 * cs_bytes + 2 * LEAF_TILE;  // C, S, then R, I
  __nv_bfloat16* ptile = reinterpret_cast<__nv_bfloat16*>(smem + a.stages * stage_bytes);
  __nv_bfloat16* spans = ptile + GROUP * a.tbw * FD;  // [spans][span_alloc]
  int* lo = reinterpret_cast<int*>(spans + a.spans * a.span_alloc);
  int* hi = lo + MEL_MAX + 4;  // [MEL_MAX + 4] each
  unsigned short* wband = reinterpret_cast<unsigned short*>(hi + MEL_MAX + 4);
  uint64_t* full = reinterpret_cast<uint64_t*>(wband + a.band_cap);
  uint64_t* empty = full + DIF_STAGES_MAX;
  uint64_t* span_full = empty + DIF_STAGES_MAX;
  uint64_t* span_empty = span_full + 2;

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DIF_STAGES_MAX; ++s) {
      mbar_init(&full[s], 1 + 8);  // the TMA issuer's arrival with the bytes; each split warp's
      mbar_init(&empty[s], 8);     // each consumer warp's
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&span_full[b], 8);   // each consumer warp's, once it has staged the span
      mbar_init(&span_empty[b], 8);  // each split warp's, once it is done with the item
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg >= 2) {
    // ---- the split: the group's leaves of each chunk into the ring; thread
    // 256 also starts the chunk's C and S loads ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
    const int st = threadIdx.x - 256, sw = st >> 5;  // split warp 0..7: frames sw, sw + 8
    int it = 0, k = 0;
    for (int item = blockIdx.x; item < a.n_items; item += gridDim.x, ++k) {
      const int b = k % a.spans;
      mbar_wait(&span_full[b], (k / a.spans) & 1);
      int w, t0;
      dif_item(a, item, w, t0);
      const __nv_bfloat16* sp = spans + b * a.span_alloc + dif_delta(a, w, t0);
      for (int pass = 0; pass < NG * a.n_bt; ++pass) {
        const int grp = pass / a.n_bt;
        for (int c = 0; c < a.n_chunks; ++c, ++it) {
          const int s = it % a.stages;
          unsigned char* sg = smem + s * stage_bytes;
          mbar_wait(&empty[s], ((it / a.stages) & 1) ^ 1);
          if (st == 0) {
            mbar_expect_tx(&full[s], 2 * cs_bytes);
            tma_load_2d(sg, &map_c, &full[s], c * KD, (pass % a.n_bt) * BTILE);
            tma_load_2d(sg + cs_bytes, &map_s, &full[s], c * KD, (pass % a.n_bt) * BTILE);
          }
          unsigned char* rt = sg + 2 * cs_bytes;  // R; I at + LEAF_TILE
#pragma unroll 1
          for (int h = 0; h < 2; ++h) {  // chunk positions lane, 32 + lane of frames sw, sw + 8
            const int kk = 32 * h + lane;
            float ur[2][GROUP], ui[2][GROUP];
            dif_split<L, 2>(sp, a, sw, c * KD + kk, grp, ur, ui);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              // row leaf * 16 + f, position kk of the chunk, 128-byte swizzle
              const int f = sw + 8 * i;
              const int off = f * 128 + (((kk >> 3) ^ (f & 7)) << 4) + ((kk & 7) << 1);
#pragma unroll
              for (int lf = 0; lf < GROUP; ++lf) {
                sts16(rt + lf * FD * 128 + off, __float2bfloat16_rn(ur[i][lf]));
                sts16(rt + LEAF_TILE + lf * FD * 128 + off, __float2bfloat16_rn(ui[i][lf]));
              }
            }
          }
          fence_async_smem();
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[s]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&span_empty[b]);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns bins wg*64 .. wg*64 + 63 of a pass ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 184;\n" ::: "memory");
  const int ct = threadIdx.x, warp = (ct >> 5) & 3, g = lane >> 2, q = lane & 3;
  dif_bands<L>(a, lo, hi, wband, ct);

  // The consumers stage the spans: item k + 1's at the start of item k
  // (two buffers), else at its end, once the split is done with item k.
  auto stage_span = [&](int item, int k) {
    const int b = k % a.spans;
    mbar_wait(&span_empty[b], ((k / a.spans) & 1) ^ 1);
    int w, t0;
    dif_item(a, item, w, t0);
    dif_load_span(a, w, t0, spans + b * a.span_alloc, ct);
    __syncwarp();
    if (lane == 0) mbar_arrive(&span_full[b]);
  };
  if (blockIdx.x < a.n_items) stage_span(blockIdx.x, 0);

  const bool rows = wg * 64 < a.tbw;  // this warpgroup holds some of a pass's bins
  int it = 0, k = 0;
  for (int item = blockIdx.x; item < a.n_items; item += gridDim.x, ++k) {
    const bool next = item + (int)gridDim.x < a.n_items;
    if (next && a.spans == 2) stage_span(item + gridDim.x, k + 1);
    int w, t0;
    dif_item(a, item, w, t0);
    float mel[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) mel[r][e] = 0.f;

    for (int pass = 0; pass < NG * a.n_bt; ++pass) {
      // xr, xi [64 bins x (leaf, frame) 128]: n8 tile i is leaf i / 2, frames
      // 8 (i % 2) + 2q, + 1; element 4i + 2h + e is bin g + 8h of the warp's
      // 16. A warpgroup without bins in the pass (tbw <= 64) multiplies rows
      // of the stage that it never stores: a branch around the wgmma would
      // serialize them.
      float xr[64], xi[64];
      int prev = -1;  // the stage whose products may still run
      for (int c = 0; c < a.n_chunks; ++c, ++it) {
        const int s = it % a.stages;
        mbar_wait(&full[s], (it / a.stages) & 1, 64);
        const unsigned char* st = smem + s * stage_bytes;
        const uint64_t dc = sw128_desc(st + wg * 64 * 128);
        const uint64_t ds = sw128_desc(st + cs_bytes + wg * 64 * 128);
        const uint64_t dr = sw128_desc(st + 2 * cs_bytes);
        const uint64_t di = sw128_desc(st + 2 * cs_bytes + LEAF_TILE);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KD / 16; ++ks) {  // the leaf products
          const int acc = c > 0 || ks > 0;
          wgmma_m64n128k16_ss<1>(xr, dc + 2 * ks, dr + 2 * ks, acc);
          wgmma_m64n128k16_ss<1>(xr, ds + 2 * ks, di + 2 * ks, 1);
          wgmma_m64n128k16_ss<1>(xi, dc + 2 * ks, di + 2 * ks, acc);
          wgmma_m64n128k16_ss<-1>(xi, ds + 2 * ks, dr + 2 * ks, 1);
        }
        wgmma_commit();
        if (a.stages > 1) {
          wgmma_wait<1>();  // the previous chunk's products are done
          if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
          prev = s;
        } else {  // one stage: free it before the next chunk can fill it
          wgmma_wait<0>();
          if (lane == 0) mbar_arrive(&empty[s]);
        }
      }
      wgmma_wait<0>();
      fence_regs(xr);
      fence_regs(xi);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

      // |X|^2 in place of xr, then |X|^power (the branch taken once, outside
      // the unrolled loops)
#pragma unroll
      for (int e = 0; e < 64; ++e) xr[e] = __fadd_rn(__fmul_rn(xr[e], xr[e]), __fmul_rn(xi[e], xi[e]));
      if (a.power == 1.f) {
#pragma unroll
        for (int e = 0; e < 64; ++e) xr[e] = sqrt_approx(xr[e]);
      } else if (a.power != 2.f) {
#pragma unroll
        for (int e = 0; e < 64; ++e) xr[e] = pow_approx(xr[e], 0.5f * a.power);
      }
      named_bar(1, 256);  // every consumer is done with the last pass's p tile
      if (rows) {
        // rounded to bf16 into the p tile [leaf][bin][frame]
#pragma unroll
        for (int i = 0; i < 16; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = wg * 64 + warp * 16 + g + 8 * h;
            if (j < a.tbw)
              *reinterpret_cast<uint32_t*>(ptile + ((i >> 1) * a.tbw + j) * FD + 8 * (i & 1) +
                                           2 * q) = pack_bf16(xr[4 * i + 2 * h], xr[4 * i + 2 * h + 1]);
          }
        }
      }
      named_bar(1, 256);  // the p tile is whole
      dif_mel_pass<L>(a, lo, hi, wband, ptile, pass / a.n_bt, (pass % a.n_bt) * BTILE, ct, mel);
    }

    // the item's outputs: rows ct / 4 + 64 r, frames t0 + 4 (ct % 4) ..
    float* ow = a.out + (long)w * a.n_mels * a.n_out;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = (ct >> 2) + 64 * r;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 4 * (ct & 3) + e;
        if (m < a.n_mels && t < a.n_out) ow[(long)m * a.n_out + t] = mel[r][e];
      }
    }
    if (next && a.spans == 1) stage_span(item + gridDim.x, k + 1);
  }
}

// Mel weights the band list holds: every bin of the leaves in two
// triangular filters at most, and one more a row; a multiple of 8.
int dif_band_cap(int levels, int bl_p, int mel_rows) {
  return ((2 << levels) * bl_p + mel_rows + 7) / 8 * 8;
}

// Shared memory of one dif block, in bytes (ops/melspec.py :: dif_smem sizes
// it the same): 1024 for alignment, the ring, the p tile, the span buffers
// (each (16 - 1) hop + n_fft samples and 3 of alignment, rounded up to 8),
// the mel bands and list offsets, the band list (where `listed`), and 10
// barriers.
size_t dif_smem_bytes(int hop, int n_fft, int levels, int bl_p, int mel_rows, int stages,
                      int spans, int listed) {
  const size_t tbw = bl_p < BTILE ? bl_p : BTILE;
  const size_t span = ((size_t)(FD - 1) * hop + n_fft + 3 + 7) / 8 * 8;
  return 1024 + (size_t)stages * (2 * tbw * KD * 2 + 2 * (size_t)LEAF_TILE) +
         (size_t)GROUP * tbw * FD * 2 + (size_t)spans * span * 2 + (2 * MEL_MAX + 8) * 4 +
         (listed ? (size_t)dif_band_cap(levels, bl_p, mel_rows) * 2 : 0) +
         (2 * DIF_STAGES_MAX + 4) * sizeof(uint64_t);
}

// (ring stages, span buffers, band list), the first that fits; without the
// band list (the deepest splits at n_fft 32768) the mel passes read the
// weights from melt
constexpr int DIF_PLANS[5][3] = {{3, 2, 1}, {2, 2, 1}, {2, 1, 1}, {1, 1, 1}, {1, 1, 0}};

struct DifDevice {
  int sms = 0, optin = 0;
};

// The current device's SMs and opt-in shared memory a block, queried once
// per device.
cudaError_t dif_device(DifDevice& d) {
  static std::mutex mu;
  static std::map<int, DifDevice> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  auto found = cache.find(dev);
  if (found == cache.end()) {
    DifDevice q;
    err = cudaDeviceGetAttribute(&q.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&q.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    found = cache.emplace(dev, q).first;
  }
  d = found->second;
  return cudaSuccess;
}

template <int L>
cudaError_t launch_dif(const CUtensorMap& mc, const CUtensorMap& ms, const DifArgs& a,
                       size_t smem, int grid, cudaStream_t st) {
  const cudaError_t err = allow_smem((const void*)stft_mel_dif_bf16_kernel<L>, smem);
  if (err != cudaSuccess) return err;
  stft_mel_dif_bf16_kernel<L><<<grid, DIF_THREADS, smem, st>>>(mc, ms, a);
  return cudaGetLastError();
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
// out [n_windows, n_mels, n_out] float32. levels 3..8; m_pad a multiple of
// 16; bl_p a multiple of 16 up to 128, else of 128; mel_rows a multiple of
// 8 up to 256. Returns cudaErrorInvalidValue where no plan's shared memory
// fits the device (dif_smem_bytes) and cudaErrorNotSupported where
// cuTensorMapEncodeTiled refuses a tensor map.
int aat_stft_mel_dif_bf16(const void* x, const void* win, const void* twc, const void* tws,
                          const void* ct, const void* st, const void* melt, void* out,
                          int n_windows, long S, int n_fft, int levels, int m_pad, int hop,
                          int n_out, int nb, int bl_p, int mel_rows, int n_mels, float power,
                          void* stream) {
  if (n_windows <= 0 || n_out <= 0) return 0;
  if (levels < 3 || levels > 8 || n_fft % (1 << levels) || m_pad % 16 ||
      m_pad < (n_fft >> levels) || bl_p % 16 || bl_p <= 0 || (bl_p > BTILE && bl_p % BTILE) ||
      nb > bl_p || nb <= 0 || mel_rows % 8 || mel_rows > MEL_MAX || n_mels > mel_rows ||
      hop <= 0)
    return (int)cudaErrorInvalidValue;
  DifDevice dev;
  cudaError_t err = dif_device(dev);
  if (err != cudaSuccess) return (int)err;
  int stages = 0, spans = 0, listed = 0;
  size_t smem = 0;
  for (const auto& plan : DIF_PLANS) {
    smem = dif_smem_bytes(hop, n_fft, levels, bl_p, mel_rows, plan[0], plan[1], plan[2]);
    if (smem <= (size_t)dev.optin) {
      stages = plan[0];
      spans = plan[1];
      listed = plan[2];
      break;
    }
  }
  if (!stages) return (int)cudaErrorInvalidValue;
  const long n_tiles = ((long)n_out + FD - 1) / FD;
  if ((long)n_windows * n_tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  DifArgs a;
  a.x = (const float*)x;
  a.win = (const float*)win;
  a.twc = (const float*)twc;
  a.tws = (const float*)tws;
  a.melt = (const __nv_bfloat16*)melt;
  a.out = (float*)out;
  a.S = S;
  a.n_fft = n_fft;
  a.m_leaf = n_fft >> levels;
  a.hop = hop;
  a.n_out = n_out;
  a.n_tiles = (int)n_tiles;
  a.n_items = (int)(n_windows * n_tiles);
  a.n_chunks = (m_pad + KD - 1) / KD;
  a.bl_p = bl_p;
  a.tbw = bl_p < BTILE ? bl_p : BTILE;
  a.n_bt = bl_p / a.tbw;
  a.n_mels = n_mels;
  a.stages = stages;
  a.spans = spans;
  a.span_alloc = (int)(((long)(FD - 1) * hop + n_fft + 3 + 7) / 8 * 8);
  a.band_cap = listed ? dif_band_cap(levels, bl_p, mel_rows) : 0;
  a.power = power;

  CUtensorMap mc, ms;
  const cuuint64_t dims[2] = {(cuuint64_t)m_pad, (cuuint64_t)bl_p};
  const cuuint64_t stride[1] = {(cuuint64_t)m_pad * 2};
  const cuuint32_t box[2] = {KD, (cuuint32_t)a.tbw};
  if (!encode_bf16(&mc, ct, 2, dims, stride, box) || !encode_bf16(&ms, st, 2, dims, stride, box))
    return (int)cudaErrorNotSupported;
  const int grid = a.n_items < dev.sms ? a.n_items : dev.sms;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (levels) {
    case 3: return (int)launch_dif<3>(mc, ms, a, smem, grid, s);
    case 4: return (int)launch_dif<4>(mc, ms, a, smem, grid, s);
    case 5: return (int)launch_dif<5>(mc, ms, a, smem, grid, s);
    case 6: return (int)launch_dif<6>(mc, ms, a, smem, grid, s);
    case 7: return (int)launch_dif<7>(mc, ms, a, smem, grid, s);
    default: return (int)launch_dif<8>(mc, ms, a, smem, grid, s);
  }
}

// Shared memory of one dif block, in bytes, for a plan of `stages` ring
// stages, `spans` span buffers and the band list where `listed`
// (ops/melspec.py :: dif_smem sizes it the same).
int aat_stft_mel_dif_bf16_smem(int hop, int n_fft, int levels, int bl_p, int mel_rows,
                               int stages, int spans, int listed) {
  return (int)dif_smem_bytes(hop, n_fft, levels, bl_p, mel_rows, stages, spans, listed);
}

}  // extern "C"
