// Framed DFT -> |X|^power -> mel on the bf16 tensor cores, for Hopper
// (sm_90a).
//
// stft_mel_bf16 replaces the Pallas kernel audio_analysis_tpu/ops/pallas/
// melspec.py:98 :: _kernel (the direct DFT-as-GEMM), and in this port it
// also serves kernel 1's (melspec.py :: _kernel_dif) exact=0 level: both are
// one contract, bf16 operands with float32 accumulation, and the fast
// frontend level (AAT_FAST=1 / AAT_PALLAS=1) sends every classify frontend
// shape and the end-scan here, whatever n_fft and however many frames.
//
// What it computes, with librosa's conventions: frame t of window x[S] is
// x[t*hop - n_fft/2 .. t*hop - n_fft/2 + n_fft), zero outside [0, S) (centre
// framing with constant padding), taken by index from the window, so no
// framed matrix exists in device memory. Each sample is rounded to bf16
// (round to nearest even); re = frame . Wr and im = frame . Wi over the
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
// What bounds it: as a function, the larger of its bytes (the float32 PCM
// read once and the output written once, over 3.35 TB/s) and the operations
// of a real FFT computing it (2.5 n_fft log2 n_fft per frame plus 2 per
// nonzero mel weight) over the 989 TFLOP/s dense bf16 rate; at the main
// path's shapes the bytes bound it. This direct DFT instead does
// 4 * bins * n_fft tensor-core operations per frame (about 2.4e11 for 64
// classify windows, a quarter of a millisecond at the bf16 peak), and the
// simple design reaches only a fraction of that peak: mma.sync rather than
// wgmma, one synchronous shared-memory stage per K chunk, one block per SM.
// Left for later: wgmma on 64-row warpgroup tiles, TMA loads of the DFT
// chunks into an mbarrier ring (the frames still need the by-index read),
// persistent blocks that overlap one tile's epilogue with the next's loads,
// and a factored DFT (the TPU kernel's DIF tree) to cut the operations.

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

}  // extern "C"
