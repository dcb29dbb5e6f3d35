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
// constant padding), read by index from the window, so no framed matrix
// exists in device memory; each sample is rounded to bf16.
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
// chunks of KCD = 32, in two shared-memory stages: after one barrier the
// [bins x 32] chunks of C and S for chunk c + 1 are started with cp.async,
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
//
// ---- direct route -------------------------------------------------------
//
// Each sample is rounded to bf16 (round to nearest even); re = frame . Wr
// and im = frame . Wi over the
// first bins (the mel filterbank's support), where Wr = cos * hann and
// Wi = -sin * hann are the Hann-folded DFT matrices, built in float64 on
// the host and rounded to float32 and then to bf16; products are bf16 x
// bf16 with float32 accumulation. p = re^2 + im^2 in float32, then sqrt for
// power 1 or p^(power/2) for any power but 2; p is rounded to bf16 and
// out[w][m][t] = sum_k p_k M[m][k], again bf16 x bf16 into float32.
//
// Design (simple first): one block of 8 warps takes a tile of TF = 64
// consecutive frames of one window and walks the bins in tiles of TB = 64.
// Per bin tile, a K loop over n_fft in chunks of KC = 64 samples stages the
// bf16 frame chunk [64 x 64] (read from the float32 window by index and
// rounded) and the Wr and Wi chunks [64 bins x 64] in shared memory; warp
// (fg, bh) runs mma.sync m16n8k16 (bf16 in, float32 accumulate) for its 16
// frames x 32 bins of re and im. The epilogue computes p in registers and
// packs it to bf16 straight into the A-operand layout of the second product
// (the m16n8k16 accumulator layout of two adjacent 8-bin tiles is the A
// fragment of one 16-bin k step), so p never leaves registers. That product,
// p [16 frames x 32 bins] x M [32 bins x n_mels], accumulates in registers
// across the bin tiles. At the end the two bin halves of each frame group
// are summed through shared memory in a fixed order, and the block writes
// its [n_mels x 64] output with frames contiguous. K that is not a multiple
// of KC (n_fft 500) is zero-padded in both operands; bins past the support
// are zero rows of Wr, Wi and M. No atomics: every output element is
// written by one block, so results do not change from run to run.
//
// What bounds it: the bytes, as for the dif route. This direct DFT does
// 4 * bins * n_fft tensor-core operations per frame, at a fraction of the
// bf16 peak: mma.sync rather than wgmma, one synchronous shared-memory
// stage per K chunk, one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TF = 64;        // frames per block
constexpr int TB = 64;        // DFT bins per bin tile
constexpr int KC = 64;        // samples per K chunk
constexpr int THREADS = 256;  // 8 warps: 4 frame groups x 2 bin halves
constexpr int LDK = KC + 8;   // row stride (bf16) of the staged chunks
constexpr int LDB = TB + 8;   // row stride (bf16) of the staged mel tile

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

// grid (n_windows * n_tiles); NMT mel tiles of 8 (the mel matrix has 8*NMT
// rows, zero past n_mels). wr/wi [bins_p][k_pad], melt [8*NMT][bins_p].
template <int NMT>
__global__ void __launch_bounds__(THREADS, 1)
stft_mel_bf16_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ wr,
                     const __nv_bfloat16* __restrict__ wi,
                     const __nv_bfloat16* __restrict__ melt, float* __restrict__ out,
                     long S, int n_fft, int k_pad, int hop, int n_out, int n_tiles,
                     int bins_p, int n_mels, float power) {
  constexpr int MR = 8 * NMT;    // mel rows
  constexpr int LDO = MR + 1;    // row stride (float) of the output tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* fr = reinterpret_cast<__nv_bfloat16*>(smem);  // [TF][LDK]
  __nv_bfloat16* cr = fr + TF * LDK;                            // [TB][LDK]
  __nv_bfloat16* ci = cr + TB * LDK;                            // [TB][LDK]
  __nv_bfloat16* ms = ci + TB * LDK;                            // [MR][LDB]
  float* ob = reinterpret_cast<float*>(smem);  // [TF][LDO], after the bin loop

  const int w = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - w * n_tiles) * TF;
  const int nf = min(TF, n_out - t0);
  const float* xw = x + (long)w * S;
  const int half = n_fft / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment row / column pair
  const int fg = warp & 3;                 // frames fg*16 .. fg*16 + 15
  const int bh = warp >> 2;                // bins bh*32 .. bh*32 + 31 of a tile

  float mel[NMT][4];
#pragma unroll
  for (int j = 0; j < NMT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mel[j][e] = 0.f;

  for (int b0 = 0; b0 < bins_p; b0 += TB) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) re[j][e] = im[j][e] = 0.f;

    for (int k0 = 0; k0 < k_pad; k0 += KC) {
      __syncthreads();  // every warp is done with the previous chunk
      // frame chunk: bf16 pairs straight from the window, by index
      for (int i = threadIdx.x; i < TF * KC / 2; i += THREADS) {
        const int f = i / (KC / 2);
        const int kk = (i - f * (KC / 2)) * 2;
        float v0 = 0.f, v1 = 0.f;
        if (f < nf) {
          const int k = k0 + kk;
          const long s = (long)(t0 + f) * hop + k - half;
          if (k < n_fft && s >= 0 && s < S) v0 = xw[s];
          if (k + 1 < n_fft && s + 1 >= 0 && s + 1 < S) v1 = xw[s + 1];
        }
        *reinterpret_cast<uint32_t*>(fr + f * LDK + kk) = pack_bf16(v0, v1);
      }
      // DFT chunks: 16-byte copies (8 bf16)
      for (int i = threadIdx.x; i < TB * KC / 8; i += THREADS) {
        const int r = i / (KC / 8);
        const int c = (i - r * (KC / 8)) * 8;
        const long src = (long)(b0 + r) * k_pad + k0 + c;
        *reinterpret_cast<uint4*>(cr + r * LDK + c) = *reinterpret_cast<const uint4*>(wr + src);
        *reinterpret_cast<uint4*>(ci + r * LDK + c) = *reinterpret_cast<const uint4*>(wi + src);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KC; ks += 16) {
        uint32_t a[4];
        const __nv_bfloat16* ap = fr + (fg * 16 + g) * LDK + ks + tq * 2;
        a[0] = ld32(ap);
        a[1] = ld32(ap + 8 * LDK);
        a[2] = ld32(ap + 8);
        a[3] = ld32(ap + 8 * LDK + 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = bh * 32 + j * 8 + g;  // bin row of this lane's B pair
          const __nv_bfloat16* bp = cr + n * LDK + ks + tq * 2;
          mma_bf16(re[j], a, ld32(bp), ld32(bp + 8));
          const __nv_bfloat16* bq = ci + n * LDK + ks + tq * 2;
          mma_bf16(im[j], a, ld32(bq), ld32(bq + 8));
        }
      }
    }

    // the mel tile, transposed: ms[m][k] = M[b0 + k][m]
    for (int i = threadIdx.x; i < MR * TB / 8; i += THREADS) {
      const int r = i / (TB / 8);
      const int c = (i - r * (TB / 8)) * 8;
      *reinterpret_cast<uint4*>(ms + r * LDB + c) =
          *reinterpret_cast<const uint4*>(melt + (long)r * bins_p + b0 + c);
    }
    __syncthreads();

    // |X|^power, rounded to bf16, packed as the A operand (k step s covers
    // this warp's bins 16s .. 16s + 15, i.e. accumulator tiles 2s, 2s + 1)
    uint32_t pa[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float p[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float r = re[2 * s + h][e], q = im[2 * s + h][e];
          p[h][e] = power_of(r * r + q * q, power);
        }
      pa[s][0] = pack_bf16(p[0][0], p[0][1]);  // row g,     bins 2tq, 2tq+1
      pa[s][1] = pack_bf16(p[0][2], p[0][3]);  // row g + 8
      pa[s][2] = pack_bf16(p[1][0], p[1][1]);  // row g,     bins 8 + 2tq, ...
      pa[s][3] = pack_bf16(p[1][2], p[1][3]);  // row g + 8
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < NMT; ++j) {
        const __nv_bfloat16* bp = ms + (j * 8 + g) * LDB + bh * 32 + s * 16 + tq * 2;
        mma_bf16(mel[j], pa[s], ld32(bp), ld32(bp + 8));
      }
  }

  // sum the two bin halves of each frame group in a fixed order
  __syncthreads();  // the staging buffers become the output tile
  const int row = fg * 16 + g;
  if (bh == 1) {
#pragma unroll
    for (int j = 0; j < NMT; ++j) {
      const int col = j * 8 + tq * 2;
      ob[row * LDO + col] = mel[j][0];
      ob[row * LDO + col + 1] = mel[j][1];
      ob[(row + 8) * LDO + col] = mel[j][2];
      ob[(row + 8) * LDO + col + 1] = mel[j][3];
    }
  }
  __syncthreads();
  if (bh == 0) {
#pragma unroll
    for (int j = 0; j < NMT; ++j) {
      const int col = j * 8 + tq * 2;
      ob[row * LDO + col] = mel[j][0] + ob[row * LDO + col];
      ob[row * LDO + col + 1] = mel[j][1] + ob[row * LDO + col + 1];
      ob[(row + 8) * LDO + col] = mel[j][2] + ob[(row + 8) * LDO + col];
      ob[(row + 8) * LDO + col + 1] = mel[j][3] + ob[(row + 8) * LDO + col + 1];
    }
  }
  __syncthreads();
  float* ow = out + (long)w * n_mels * n_out + t0;
  for (int i = threadIdx.x; i < n_mels * TF; i += THREADS) {
    const int m = i / TF;
    const int f = i - m * TF;
    if (f < nf) ow[(long)m * n_out + f] = ob[f * LDO + m];
  }
}

size_t smem_bytes(int mel_rows) {
  const size_t stage = sizeof(__nv_bfloat16) * ((size_t)(TF + 2 * TB) * LDK + (size_t)mel_rows * LDB);
  const size_t tile = sizeof(float) * (size_t)TF * (mel_rows + 1);
  return stage > tile ? stage : tile;
}

template <int NMT>
cudaError_t launch(int n_blocks, cudaStream_t st, const float* x, const __nv_bfloat16* wr,
                   const __nv_bfloat16* wi, const __nv_bfloat16* melt, float* out, long S,
                   int n_fft, int k_pad, int hop, int n_out, int n_tiles, int bins_p,
                   int n_mels, float power) {
  const size_t smem = smem_bytes(8 * NMT);
  cudaError_t err = cudaFuncSetAttribute(
      stft_mel_bf16_kernel<NMT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  stft_mel_bf16_kernel<NMT><<<n_blocks, THREADS, smem, st>>>(
      x, wr, wi, melt, out, S, n_fft, k_pad, hop, n_out, n_tiles, bins_p, n_mels, power);
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
  cudaError_t err = cudaFuncSetAttribute(stft_mel_dif_bf16_kernel<L, NTH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

// x [n_windows, S] float32; wr, wi [bins_p, k_pad] bf16 (Hann-folded cos and
// -sin, zero past n_fft and past the mel support); melt [mel_rows, bins_p]
// bf16 (the mel matrix transposed, zero rows past n_mels); out
// [n_windows, n_mels, n_out] float32 holds the first n_out frames of each
// window. k_pad is a multiple of 64, bins_p a multiple of 64, mel_rows one
// of 64, 128, 160, 256.
int aat_stft_mel_bf16(const void* x, const void* wr, const void* wi, const void* melt,
                      void* out, int n_windows, long S, int n_fft, int k_pad, int hop,
                      int n_out, int bins_p, int mel_rows, int n_mels, float power,
                      void* stream) {
  if (n_windows <= 0 || n_out <= 0) return 0;
  if (k_pad % KC || bins_p % TB || bins_p <= 0 || k_pad < n_fft || n_mels > mel_rows)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (n_out + TF - 1) / TF;
  if ((long)n_windows * n_tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const int n_blocks = n_windows * n_tiles;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const __nv_bfloat16* r = (const __nv_bfloat16*)wr;
  const __nv_bfloat16* i = (const __nv_bfloat16*)wi;
  const __nv_bfloat16* m = (const __nv_bfloat16*)melt;
  float* o = (float*)out;
  switch (mel_rows) {
    case 64: return (int)launch<8>(n_blocks, st, xf, r, i, m, o, S, n_fft, k_pad, hop, n_out, n_tiles, bins_p, n_mels, power);
    case 128: return (int)launch<16>(n_blocks, st, xf, r, i, m, o, S, n_fft, k_pad, hop, n_out, n_tiles, bins_p, n_mels, power);
    case 160: return (int)launch<20>(n_blocks, st, xf, r, i, m, o, S, n_fft, k_pad, hop, n_out, n_tiles, bins_p, n_mels, power);
    case 256: return (int)launch<32>(n_blocks, st, xf, r, i, m, o, S, n_fft, k_pad, hop, n_out, n_tiles, bins_p, n_mels, power);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
