// Framed real DFT in float64 with a mel or a magnitude epilogue, for Hopper
// (sm_90a).
//
// stft_mel replaces the Pallas kernel audio_analysis_tpu/ops/pallas/melspec.py
// :: _kernel_dif (classify frontend, n_fft 4096 / hop 640 / 160 mels, and the
// end-scan, n_fft 4800 / hop 281 / 120 mels). stft_mag replaces
// melspec.py :: _kernel_dif_mag (detection |STFT|, n_fft 4096 / hop 281, all
// 1 + n_fft/2 bins in natural order, Nyquist included).
//
// What they compute, with librosa's conventions: frame t of a signal x[S] is
// x[t*hop - n_fft/2 .. t*hop - n_fft/2 + n_fft), zero outside [0, S) (centre
// framing with constant padding); it is multiplied by the periodic Hann
// window in float32, widened to float64, and its real DFT
// X_k = sum_n x_n e^{-2 pi i k n / n_fft} is taken in float64. stft_mag writes
// |X_k|^power rounded to float32 as out[b][k][t]; stft_mel writes
// out[w][m][t] = sum_k fb[m][k] |X_k|^power over each filter's nonzero
// support [fb_lo[m], fb_hi[m]), float64 products of the float32 operands,
// rounded to float32. The plain versions (ops/melspec.py) compute the same
// with torch.fft in float64. Float64 is the contract: the detection mask
// flips bits at ~5e-5 relative error at 1e-3 of the maximum bin, where a
// float32 FFT is off by 2-8e-5.
//
// Four routes, picked by the wrapper from n_fft and the card's shared memory
// alone (ops/melspec.py :: stft_plan, which also sizes the tiles):
//
// * fft: n_fft whose prime factors are 2, 3, 5 and 7 (4096 = 8^4,
//   4800 = 8^2 * 3 * 5^2, 4410 = 2 * 3^2 * 5 * 7^2) and whose two buffers
//   fit. One block of 512 threads owns a tile of TF consecutive frames of
//   one signal and takes them two at a time as one complex FFT, z = frame_a + i frame_b,
//   staged from the signal by index (no framed matrix exists in device
//   memory). The FFT is a mixed-radix Stockham autosort in shared memory:
//   each pass of radix R reads butterfly j's R points at stride n/R,
//   multiplies them by their twiddles, takes the R-point DFT in registers
//   (radix 2 and 4 exact, 8 as two radix-4 DFTs and the w8 rotations, 3, 5
//   and 7 directly with table constants), and writes them at stride ns (the
//   product of the earlier radices) into the other buffer, so the result
//   lands in natural order without a bit-reversal pass. The radix sequence
//   (8s first) and the float64 cos/sin table (built in float64 on the host)
//   come from the wrapper. Each block copies a two-level table from it into
//   shared memory (e^{-2 pi i 64 h / n} and e^{-2 pi i l / n}, l < 64: 2 KB
//   at n 4096), and a twiddle is the product of two entries, one rounding
//   from the table's value, never advanced by a recurrence: the FFT stays
//   near 1e-15 relative. The two spectra are split with
//   X_a[k] = (Z[k] + conj Z[n-k]) / 2 and X_b[k] = (Z[k] - conj Z[n-k]) / 2i.
//   Pairing leaves
//   rounding residue of a non-zero partner in an all-zero frame, so staging
//   flags each frame's non-zero samples block-wide and an all-zero frame is
//   written as exact zeros. |X|^power goes into a float32 tile in shared
//   memory: stft_mag's [bins][TF + 1] tile (padded against bank conflicts) is
//   written out as rows of TF contiguous frames (32 bytes at TF 8); stft_mel
//   sums its [TF][bins] tile over each filter's support.
// * fft1: the same FFT in one complex buffer, for an n_fft whose two buffers
//   do not fit (8192) or with a prime factor from 11 to 61
//   (4400 = 8 * 2 * 5^2 * 11, 832 = 8^2 * 13, 8704 = 8^3 * 17). Radix 11 and 13 take the
//   pairs r, R - r (sums and differences, half the products), an odd prime up
//   to 61 a generic pass: each output the R-term sum of its inputs, each
//   times one twiddle from the table. Staging writes sample i at the position
//   the host's digit-reversal table gives it, and the passes are the in-place
//   Cooley-Tukey passes of the same plan: butterfly (g, jm) of the pass with
//   stride ns reads and writes the R points g R ns + jm + r ns, with the
//   Stockham pass's twiddles and butterflies, so each output is the same
//   arithmetic and lands in natural order. The generic prime pass holds its
//   outputs in registers across a barrier (n_fft <= HELD * 512). stft_mag
//   has no tile and writes each pair's bins straight to the output; stft_mel
//   keeps its [TF][bins] tile.
// * bluestein: an n_fft with a prime factor above 61 whose
//   padded length M (the smallest product of 2, 3, 5 and 7 at least
//   2 n_fft - 1) fits one buffer (4099, for one). z_k times the chirp
//   e^{-i pi k^2 / n} (k^2 mod 2n, one entry of a host table), zero-padded to
//   M; the forward FFT by decimation in frequency (the in-place passes
//   transposed: butterfly first, then the twiddles, last pass first), which
//   leaves the spectrum in the digit-reversed order; times the FFT of the
//   conjugate chirp (built in float64 on the host, divided by M, stored in
//   that order) and conjugated; the in-place passes again, which restore the
//   natural order; conjugated and times the chirp: the n-point DFT of z,
//   split as above.
// * cluster: an n_fft whose one buffer does not fit one block (12800 and up
//   for stft_mag, 12000 and up for stft_mel on the classify grid, the prime
//   6301, whose Bluestein length 12800 does not fit either): the transform of
//   N = c m points (n_fft, else a Bluestein length) split over a cluster of
//   c = 2, 3, 4, 5, 7 or 8 blocks on neighbouring SMs, each holding m points
//   in its one buffer; a block reads and writes the others' shared memory
//   (distributed shared memory, cooperative_groups::this_cluster(),
//   map_shared_rank) between cluster barriers (ops/melspec.py ::
//   cluster_plan takes the first N and the smallest c whose block fits).
//   Split N = c m, point j = p + m r (block r stages the contiguous chunk
//   [r m, (r + 1) m) of the pair z = frame_a + i frame_b) and bin
//   k = c k1 + k2: X[c k1 + k2] = sum_p W_m^{p k1} W_N^{p k2}
//   sum_r x[p + m r] W_c^{r k2}. One exchange pass crosses the cluster: the
//   cluster's threads take the m buffer addresses in turn (consecutive
//   threads, consecutive addresses: no bank conflicts, local or remote),
//   each reads the point p at that address in every block, takes the
//   c-point DFT (the radix-c butterfly), multiplies output k2 by W_N^{p k2}
//   (one entry of a host float64 table laid out by address, one rounding)
//   and writes it to the same address of block k2, so every point crosses
//   the cluster once and the pass runs in place. Each block then
//   runs fft1's in-place passes over its m points (staged at
//   fft_positions, so they come out in natural order): block r holds bins
//   k = c k1 + r. The pair split needs Z[n - k], which lies in block
//   -r mod c, read remotely after a cluster barrier; block r computes its
//   own bins' |X|^power (stft_mag writes them straight to the output;
//   stft_mel keeps a [tf][ceil(bins / c)] tile, and after a cluster barrier
//   the cluster's threads take the mel outputs in turn, reading each bin
//   from its block's tile, summed in bin order). Bluestein over a cluster:
//   the chirp product over a length N at least 2 n_fft - 1; the forward
//   transform is the same exchange on natural order followed by each
//   block's passes by decimation in frequency, which leaves bin c k1 + r in
//   block r at fft_positions(m)[k1]; the host stores the conjugate chirp's
//   FFT in that order, so the product needs no redistribution; the inverse
//   is the transpose: each block's in-place passes (natural k1 out), times
//   W_N^{r k1}, and the exchange by decimation in time, which leaves point
//   k of the result in block k / m at k mod m. Four cluster barriers a
//   pair (six with Bluestein) and one a tile; the frames' all-zero flags
//   are or-ed over the blocks after staging. Each exchange point costs
//   remote reads and writes of c complex values, and the cluster's blocks
//   (one an SM, ~150-220 KB each) must be resident together in one GPC:
//   the launcher checks cudaOccupancyMaxActiveClusters and returns an
//   error when it is 0.
//
// What bounds them: as functions, the larger of their bytes (the PCM read
// once, the output written once, over 3.35 TB/s) and the operations of a
// real FFT (2.5 n_fft log2 n_fft per frame, plus 2 per nonzero mel weight)
// over the 67 TFLOP/s float32 peak. stft_mag, which writes every bin, is
// bound by its bytes (84 MB for a 60 s recording); stft_mel, whose mel
// output is small, by those operations. The FFT itself does ~5 n log2 n
// float64 operations per pair of frames, a few hundredths of a millisecond
// of the card's float64 rate per recording. What holds the design is
// latency in one block per SM: two complex buffers (ping-pong, one spare
// double after every 8 so that the stride-8 writes of the first passes hit
// distinct banks), the twiddle table and the tile fill the SM's shared
// memory, so a pass's shared-memory and twiddle reads, the staging's reads
// of the signal and the tile's write-out are not overlapped by another
// block's work; a barrier ends each pass. The one-buffer routes hold the
// same latency-bound shape: fft1 does the fft route's passes in place
// (at 8192, 2x the points of 4096 and one more pass); bluestein does two
// FFTs of M >= 2 n_fft - 1 points and two pointwise passes a pair, ~4x the
// fft route's work at the same n_fft. The cluster route adds, to fft1's
// passes over m = N / c points in each block, the exchange pass through
// distributed shared memory and the cluster barriers around it: its blocks
// wait on the slowest of c, and its exchange's remote loads and stores sit
// on the critical path of each pair (latency, not bandwidth: c m complex
// doubles cross the SM-to-SM network a pass). No atomics: every output is
// written once by one thread, so two launches agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int FFT_THREADS = 512;  // threads a block, every route
constexpr int TW_LO = 64;         // low level of the fft route's twiddle table
constexpr int HELD = 26;          // outputs a thread holds in the in-place generic pass
enum Route { FFT1 = 1, BLUESTEIN = 2 };  // the one-buffer routes

// Entries of each half (cos, sin) of the fft route's two-level twiddle table.
__host__ __device__ constexpr int twiddle_rows(int n) {
  return (n + TW_LO - 1) / TW_LO + TW_LO;
}

// The fft route keeps point i of a complex buffer at pad(i), one spare
// double after every 8, so that a pass's stride-8 writes (8 consecutive
// points per thread when ns = 1, runs of 8 when ns = 8) hit distinct banks;
// each half (re, im) of a buffer holds padded(n) doubles.
__host__ __device__ constexpr int pad(int i) { return i + (i >> 3); }
__host__ __device__ constexpr int padded(int n) { return n + (n >> 3); }

__device__ __forceinline__ float power_of(double re, double im, float power) {
  const double p2 = re * re + im * im;
  if (power == 2.f) return (float)p2;
  const double mag = sqrt(p2);
  if (power == 1.f) return (float)mag;
  return (float)pow(mag, (double)power);
}

// out[w][m][t0 + f] = sum over fb row m's support of fb[m][k] * pw[f][k],
// for the nf frames of the tile; pw [TF, bins] float32.
__device__ void mel_epilogue(const float* pw, const float* __restrict__ fb,
                             const int* __restrict__ fb_lo, const int* __restrict__ fb_hi,
                             float* __restrict__ out, int w, int t0, int nf, int n_out,
                             int bins, int n_mels) {
  for (int o = threadIdx.x; o < nf * n_mels; o += blockDim.x) {
    const int m = o / nf;
    const int f = o - m * nf;
    const float* row = fb + (long)m * bins;
    const float* p = pw + f * bins;
    double acc = 0.0;
    for (int k = fb_lo[m]; k < fb_hi[m]; ++k) acc += (double)row[k] * (double)p[k];
    out[((long)w * n_mels + m) * n_out + t0 + f] = (float)acc;
  }
}

// ---------------------------------------------------------------------------
// fft route
// ---------------------------------------------------------------------------

// (re + i im) * (c - i s): a twiddle e^{-i theta} given as
// c = cos(theta), s = sin(theta).
__device__ __forceinline__ void twiddle(double& re, double& im, double c, double s) {
  const double r = fma(re, c, im * s);
  im = fma(im, c, -re * s);
  re = r;
}

// R = 11, 13: with s_r = v_r + v_{R-r} and d_r = v_r - v_{R-r} (r <= H),
// A = v_0 + sum_r s_r cos(2 pi r k / R) and B = sum_r d_r sin(2 pi r k / R),
// V[k] = A - i B and V[R - k] = A + i B: half the products of the direct
// sum, and only the constants q <= H.
template <int R>
__device__ __forceinline__ void butterfly_pairs(double (&vr)[R], double (&vi)[R],
                                                const double (&wc)[R], const double (&ws)[R]) {
  constexpr int H = (R - 1) / 2;
  double sr[H], si[H], dr[H], di[H];
  const double v0r = vr[0], v0i = vi[0];
  double tr = v0r, ti = v0i;
#pragma unroll
  for (int r = 1; r <= H; ++r) {
    sr[r - 1] = vr[r] + vr[R - r];
    si[r - 1] = vi[r] + vi[R - r];
    dr[r - 1] = vr[r] - vr[R - r];
    di[r - 1] = vi[r] - vi[R - r];
    tr += sr[r - 1];
    ti += si[r - 1];
  }
  vr[0] = tr;
  vi[0] = ti;
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    double ar = v0r, ai = v0i, br = 0.0, bi = 0.0;
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      const int q = (r * k) % R;
      const double c = q <= H ? wc[q] : wc[R - q];
      const double s = q <= H ? ws[q] : -ws[R - q];
      ar = fma(sr[r - 1], c, ar);
      ai = fma(si[r - 1], c, ai);
      br = fma(dr[r - 1], s, br);
      bi = fma(di[r - 1], s, bi);
    }
    vr[k] = ar + bi;
    vi[k] = ai - br;
    vr[R - k] = ar - bi;
    vi[R - k] = ai + br;
  }
}

// R-point DFT in place, V[k] = sum_r v[r] w^{rk}, w = e^{-2 pi i / R};
// wc/ws[q] = cos/sin(2 pi q / R). Odd R: directly (11 and 13 by pairs).
template <int R>
__device__ __forceinline__ void butterfly(double (&vr)[R], double (&vi)[R],
                                          const double (&wc)[R], const double (&ws)[R]) {
  if constexpr (R >= 11) {
    butterfly_pairs<R>(vr, vi, wc, ws);
  } else {
    double yr[R], yi[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      double sr = vr[0], si = vi[0];
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const int q = (r * k) % R;
        sr = fma(vr[r], wc[q], fma(vi[r], ws[q], sr));
        si = fma(vi[r], wc[q], fma(-vr[r], ws[q], si));
      }
      yr[k] = sr;
      yi[k] = si;
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      vr[k] = yr[k];
      vi[k] = yi[k];
    }
  }
}

template <>
__device__ __forceinline__ void butterfly<2>(double (&vr)[2], double (&vi)[2],
                                             const double (&)[2], const double (&)[2]) {
  const double r = vr[0] - vr[1], i = vi[0] - vi[1];
  vr[0] += vr[1];
  vi[0] += vi[1];
  vr[1] = r;
  vi[1] = i;
}

template <>
__device__ __forceinline__ void butterfly<4>(double (&vr)[4], double (&vi)[4],
                                             const double (&)[4], const double (&)[4]) {
  const double ar = vr[0] + vr[2], ai = vi[0] + vi[2];
  const double br = vr[0] - vr[2], bi = vi[0] - vi[2];
  const double cr = vr[1] + vr[3], ci = vi[1] + vi[3];
  const double dr = vr[1] - vr[3], di = vi[1] - vi[3];
  vr[0] = ar + cr;  vi[0] = ai + ci;
  vr[1] = br + di;  vi[1] = bi - dr;  // b - i d
  vr[2] = ar - cr;  vi[2] = ai - ci;
  vr[3] = br - di;  vi[3] = bi + dr;  // b + i d
}

template <>
__device__ __forceinline__ void butterfly<8>(double (&vr)[8], double (&vi)[8],
                                             const double (&)[8], const double (&)[8]) {
  // two 4-point DFTs of the even and odd points, then V[k] = E[k] + w8^k O[k]
  // and V[k + 4] = E[k] - w8^k O[k], w8 = e^{-i pi / 4}
  constexpr double h = 0.70710678118654752440;  // sqrt(1/2)
  double er[4] = {vr[0], vr[2], vr[4], vr[6]}, ei[4] = {vi[0], vi[2], vi[4], vi[6]};
  double orr[4] = {vr[1], vr[3], vr[5], vr[7]}, oi[4] = {vi[1], vi[3], vi[5], vi[7]};
  const double (&none)[4] = er;  // radix 4 takes no constants
  butterfly<4>(er, ei, none, none);
  butterfly<4>(orr, oi, none, none);
  const double t1r = (orr[1] + oi[1]) * h, t1i = (oi[1] - orr[1]) * h;  // w8 O1
  const double t2r = oi[2], t2i = -orr[2];                              // -i O2
  const double t3r = (oi[3] - orr[3]) * h, t3i = -(orr[3] + oi[3]) * h;  // w8^3 O3
  vr[0] = er[0] + orr[0];  vi[0] = ei[0] + oi[0];
  vr[4] = er[0] - orr[0];  vi[4] = ei[0] - oi[0];
  vr[1] = er[1] + t1r;     vi[1] = ei[1] + t1i;
  vr[5] = er[1] - t1r;     vi[5] = ei[1] - t1i;
  vr[2] = er[2] + t2r;     vi[2] = ei[2] + t2i;
  vr[6] = er[2] - t2r;     vi[6] = ei[2] - t2i;
  vr[3] = er[3] + t3r;     vi[3] = ei[3] + t3i;
  vr[7] = er[3] - t3r;     vi[7] = ei[3] - t3i;
}

// The twiddle e^{-2 pi i t / n} for t < n, from the two-level table tw in
// shared memory: tw[h] = e^{-2 pi i 64 h / n} for h < nh = ceil(n / 64),
// tw[nh + l] = e^{-2 pi i l / n} for l < 64 (cos in tw[0, nt), sin in
// tw[nt, 2 nt), nt = nh + 64), both copied from the float64 table; their
// product rounds once more, ~1e-16.
__device__ __forceinline__ void twiddle_of(const double* tw, int nh, int t, double& c,
                                           double& s) {
  const int nt = nh + TW_LO;
  const int h = t / TW_LO, l = nh + t % TW_LO;
  const double c1 = tw[h], s1 = tw[nt + h], c0 = tw[l], s0 = tw[nt + l];
  c = fma(c1, c0, -s1 * s0);
  s = fma(s1, c0, c1 * s0);
}

// Fills the two-level twiddle table (twiddle_of) from cs/sn.
__device__ void load_twiddles(double* tw, int n, const double* __restrict__ cs,
                              const double* __restrict__ sn) {
  const int nh = (n + TW_LO - 1) / TW_LO, nt = nh + TW_LO;
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    const int q = i < nh ? i * TW_LO : i - nh;
    tw[i] = q < n ? cs[q] : 1.0;
    tw[nt + i] = q < n ? sn[q] : 0.0;
  }
}

// One Stockham pass of radix R over n points: butterfly j (j < n/R) reads
// src[j + r n/R], twiddles point r by e^{-2 pi i r (j mod ns) / (ns R)}
// (table index r (j mod ns) n / (ns R)), and writes
// dst[(j - j mod ns) R + j mod ns + r ns]. ns is the product of the radices
// of the earlier passes.
template <int R>
__device__ void fft_pass(const double* __restrict__ sr, const double* __restrict__ si,
                         double* __restrict__ dr, double* __restrict__ di, int n, int ns,
                         const double* tw, const double* __restrict__ cs,
                         const double* __restrict__ sn) {
  const int m = n / R;
  const int step = m / ns;
  const int nh = (n + TW_LO - 1) / TW_LO;
  double wc[R], ws[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    wc[q] = __ldg(cs + q * m);
    ws[q] = __ldg(sn + q * m);
  }
#pragma unroll 2
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int jm = j % ns;
    double vr[R], vi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      vr[r] = sr[pad(j + r * m)];
      vi[r] = si[pad(j + r * m)];
    }
#pragma unroll
    for (int r = 1; r < R; ++r) {
      double c, s;
      twiddle_of(tw, nh, r * jm * step, c, s);
      twiddle(vr[r], vi[r], c, s);
    }
    butterfly<R>(vr, vi, wc, ws);
    const int d = (j - jm) * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      dr[pad(d + r * ns)] = vr[r];
      di[pad(d + r * ns)] = vi[r];
    }
  }
}

// Output q of butterfly (first, stride) of a pass of odd prime radix R:
// sum_r v_r e^{-2 pi i r t1 / n}, v_r = (re, im)[pad(first + r stride)], the
// exponent r t1 mod n kept exactly and each term's twiddle read from the
// table (twiddle_of). t1 = jm step + q m folds the pass's twiddle
// e^{-2 pi i r jm step / n} and the DFT's e^{-2 pi i r q / R} into one.
__device__ __forceinline__ void prime_output(const double* re, const double* im, int first,
                                             int stride, int R, int t1, int n, int nh,
                                             const double* tw, double& ar, double& ai) {
  ar = re[pad(first)];
  ai = im[pad(first)];
  int t = 0;
  for (int r = 1; r < R; ++r) {
    t += t1;
    if (t >= n) t -= n;
    double c, s, vr = re[pad(first + r * stride)], vi = im[pad(first + r * stride)];
    twiddle_of(tw, nh, t, c, s);
    twiddle(vr, vi, c, s);
    ar += vr;
    ai += vi;
  }
}

// The complex FFT of the n points in a (re at a[pad(i)], im at
// a[padded(n) + pad(i)]), with b as the other buffer of the same size and tw
// the two-level twiddle table; returns the buffer holding the result.
__device__ const double* fft(double* a, double* b, const double* tw, int n,
                             const int* __restrict__ radix, int n_pass,
                             const double* __restrict__ cs, const double* __restrict__ sn) {
  const int np = padded(n);
  int ns = 1;
  for (int p = 0; p < n_pass; ++p) {
    const int r = __ldg(radix + p);
    switch (r) {
      case 8: fft_pass<8>(a, a + np, b, b + np, n, ns, tw, cs, sn); break;
      case 4: fft_pass<4>(a, a + np, b, b + np, n, ns, tw, cs, sn); break;
      case 2: fft_pass<2>(a, a + np, b, b + np, n, ns, tw, cs, sn); break;
      case 3: fft_pass<3>(a, a + np, b, b + np, n, ns, tw, cs, sn); break;
      case 5: fft_pass<5>(a, a + np, b, b + np, n, ns, tw, cs, sn); break;
      default: fft_pass<7>(a, a + np, b, b + np, n, ns, tw, cs, sn); break;
    }
    __syncthreads();
    double* t = a;
    a = b;
    b = t;
    ns *= r;
  }
  return a;
}

// ---------------------------------------------------------------------------
// one-buffer routes (fft1, bluestein)
// ---------------------------------------------------------------------------

// The in-place pass of radix R with stride ns over the n points of one
// buffer: butterfly b (b < n/R), g = b / ns, jm = b mod ns, owns the points
// g R ns + jm + r ns. Decimation in time (DIF false): twiddles
// e^{-2 pi i r jm step / n} on the inputs, then the R-point DFT, as
// fft_pass. Decimation in frequency (DIF true, the transpose): the DFT, then
// the same twiddles on the outputs.
template <int R, bool DIF>
__device__ void fft_pass_inplace(double* re, double* im, int n, int ns, const double* tw,
                                 const double* __restrict__ cs,
                                 const double* __restrict__ sn) {
  const int m = n / R;
  const int step = m / ns;
  const int nh = (n + TW_LO - 1) / TW_LO;
  double wc[R], ws[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    wc[q] = __ldg(cs + q * m);
    ws[q] = __ldg(sn + q * m);
  }
  for (int b = threadIdx.x; b < m; b += blockDim.x) {
    const int g = b / ns, jm = b - g * ns;
    const int base = g * R * ns + jm;
    double vr[R], vi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      vr[r] = re[pad(base + r * ns)];
      vi[r] = im[pad(base + r * ns)];
    }
    if (!DIF) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        double c, s;
        twiddle_of(tw, nh, r * jm * step, c, s);
        twiddle(vr[r], vi[r], c, s);
      }
    }
    butterfly<R>(vr, vi, wc, ws);
    if (DIF) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        double c, s;
        twiddle_of(tw, nh, r * jm * step, c, s);
        twiddle(vr[r], vi[r], c, s);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      re[pad(base + r * ns)] = vr[r];
      im[pad(base + r * ns)] = vi[r];
    }
  }
}

// The in-place pass of an odd prime radix R above 13 (decimation in time):
// each thread computes its outputs o = threadIdx.x + u FFT_THREADS
// (q = o / m, butterfly o mod m) into registers, then, after a barrier,
// writes them over the inputs. n <= HELD * FFT_THREADS.
__device__ void fft_pass_prime_inplace(double* re, double* im, int n, int ns, int R,
                                       const double* tw) {
  const int m = n / R;
  const int step = m / ns;
  const int nh = (n + TW_LO - 1) / TW_LO;
  double hr[HELD], hi[HELD];
#pragma unroll
  for (int u = 0; u < HELD; ++u) {
    const int o = threadIdx.x + u * FFT_THREADS;
    if (o < n) {
      const int q = o / m, b = o - q * m, g = b / ns, jm = b - g * ns;
      prime_output(re, im, g * R * ns + jm, ns, R, jm * step + q * m, n, nh, tw, hr[u], hi[u]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < HELD; ++u) {
    const int o = threadIdx.x + u * FFT_THREADS;
    if (o < n) {
      const int q = o / m, b = o - q * m, g = b / ns, jm = b - g * ns;
      const int d = g * R * ns + jm + q * ns;
      re[pad(d)] = hr[u];
      im[pad(d)] = hi[u];
    }
  }
}

// The complex FFT of the n points in a, in place: its input in the
// digit-reversed order of the plan (fft_positions on the host), its output
// in natural order. WIDE false builds only the passes of 8, 4, 2, 3, 5 and 7
// (Bluestein's M); true adds 11, 13 and the generic prime pass (fft1).
template <bool WIDE>
__device__ void fft_inplace(double* a, const double* tw, int n, const int* __restrict__ radix,
                            int n_pass, const double* __restrict__ cs,
                            const double* __restrict__ sn) {
  double* ai = a + padded(n);
  int ns = 1;
  for (int p = 0; p < n_pass; ++p) {
    const int r = __ldg(radix + p);
    switch (r) {
      case 8: fft_pass_inplace<8, false>(a, ai, n, ns, tw, cs, sn); break;
      case 4: fft_pass_inplace<4, false>(a, ai, n, ns, tw, cs, sn); break;
      case 2: fft_pass_inplace<2, false>(a, ai, n, ns, tw, cs, sn); break;
      case 3: fft_pass_inplace<3, false>(a, ai, n, ns, tw, cs, sn); break;
      case 5: fft_pass_inplace<5, false>(a, ai, n, ns, tw, cs, sn); break;
      case 7: fft_pass_inplace<7, false>(a, ai, n, ns, tw, cs, sn); break;
      default:
        if constexpr (WIDE) {
          if (r == 11) fft_pass_inplace<11, false>(a, ai, n, ns, tw, cs, sn);
          else if (r == 13) fft_pass_inplace<13, false>(a, ai, n, ns, tw, cs, sn);
          else fft_pass_prime_inplace(a, ai, n, ns, r, tw);
        }
        break;
    }
    __syncthreads();
    ns *= r;
  }
}

// The transpose of fft_inplace, for radices 8, 4, 2, 3, 5, 7: natural order
// in, the digit-reversed order out.
__device__ void fft_inplace_dif(double* a, const double* tw, int n,
                                const int* __restrict__ radix, int n_pass,
                                const double* __restrict__ cs, const double* __restrict__ sn) {
  double* ai = a + padded(n);
  int ns = n;
  for (int p = n_pass - 1; p >= 0; --p) {
    const int r = __ldg(radix + p);
    ns /= r;
    switch (r) {
      case 8: fft_pass_inplace<8, true>(a, ai, n, ns, tw, cs, sn); break;
      case 4: fft_pass_inplace<4, true>(a, ai, n, ns, tw, cs, sn); break;
      case 2: fft_pass_inplace<2, true>(a, ai, n, ns, tw, cs, sn); break;
      case 3: fft_pass_inplace<3, true>(a, ai, n, ns, tw, cs, sn); break;
      case 5: fft_pass_inplace<5, true>(a, ai, n, ns, tw, cs, sn); break;
      default: fft_pass_inplace<7, true>(a, ai, n, ns, tw, cs, sn); break;
    }
    __syncthreads();
  }
}

// What the one-buffer routes read besides the signal and the window.
struct OneBuffer {
  const double* cs;   // cos(2 pi j / N), j < N: N = n_fft (fft1) or M (bluestein)
  const double* sn;   // sin(2 pi j / N)
  const int* radix;   // the plan of N
  int n_pass;
  int m;              // N
  const int* perm;    // fft1: the position sample i is staged at
  const double* chc;  // bluestein: cos(pi (k^2 mod 2n) / n), k < n_fft
  const double* chs;  // bluestein: sin(pi (k^2 mod 2n) / n)
  const double* bc;   // bluestein: the FFT of the conjugate chirp over M, in DIF order
  const double* bs;
};

// Frame ta's (and, when has_b, ta + 1's) sample i, windowed in float32.
__device__ __forceinline__ void frame_samples(const float* __restrict__ x,
                                              const float* __restrict__ win, long S, long s,
                                              int hop, int i, bool has_b, float& va,
                                              float& vb) {
  const float w = win[i];
  va = (s >= 0 && s < S) ? x[s] * w : 0.f;
  vb = (has_b && s + hop >= 0 && s + hop < S) ? x[s + hop] * w : 0.f;
}

// stage_pair for the one-buffer routes: fft1 puts sample i at perm[i];
// bluestein multiplies it by the chirp and zero-fills [n, M). Returns the
// frames' non-zero flags, as stage_pair.
template <int ROUTE>
__device__ int stage_one(double* a, const float* __restrict__ x, const float* __restrict__ win,
                         long S, int n, int hop, int ta, bool has_b, const OneBuffer& d) {
  const long s0 = (long)ta * hop - n / 2;
  const int np = padded(d.m);
  int nz = 0;
  for (int i = threadIdx.x; i < d.m; i += blockDim.x) {
    double zr = 0.0, zi = 0.0;
    int at = i;
    if (i < n) {
      float va, vb;
      frame_samples(x, win, S, s0 + i, hop, i, has_b, va, vb);
      nz |= (va != 0.f ? 1 : 0) | (vb != 0.f ? 2 : 0);
      zr = (double)va;
      zi = (double)vb;
      if (ROUTE == FFT1) at = __ldg(d.perm + i);
      else twiddle(zr, zi, __ldg(d.chc + i), __ldg(d.chs + i));
    }
    a[pad(at)] = zr;
    a[np + pad(at)] = zi;
  }
  const int frame_a = __syncthreads_or(nz & 1) ? 1 : 0;
  const int frame_b = __syncthreads_or(nz & 2) ? 2 : 0;
  return frame_a | frame_b;
}

// The n-point DFT of the staged z by Bluestein's chirp product, in place in
// the buffer of M points; the spectrum ends in a[pad(k)], k < n (imaginary
// parts at padded(M)).
__device__ void bluestein(double* a, const double* tw, int n, const OneBuffer& d) {
  const int np = padded(d.m);
  fft_inplace_dif(a, tw, d.m, d.radix, d.n_pass, d.cs, d.sn);
  for (int p = threadIdx.x; p < d.m; p += blockDim.x) {
    const double xr = a[pad(p)], xi = a[np + pad(p)];
    const double br = __ldg(d.bc + p), bi = __ldg(d.bs + p);
    a[pad(p)] = fma(xr, br, -xi * bi);
    a[np + pad(p)] = -fma(xr, bi, xi * br);  // conjugated
  }
  __syncthreads();
  fft_inplace<false>(a, tw, d.m, d.radix, d.n_pass, d.cs, d.sn);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    double zr = a[pad(k)], zi = -a[np + pad(k)];  // conjugated
    twiddle(zr, zi, __ldg(d.chc + k), __ldg(d.chs + k));
    a[pad(k)] = zr;
    a[np + pad(k)] = zi;
  }
  __syncthreads();
}

// The pair's spectrum in a, by the route's transform.
template <int ROUTE>
__device__ void transform_one(double* a, const double* tw, int n, const OneBuffer& d) {
  if (ROUTE == FFT1) fft_inplace<true>(a, tw, n, d.radix, d.n_pass, d.cs, d.sn);
  else bluestein(a, tw, n, d);
}

// Stages frames ta and ta + 1 (the second only when has_b) of x[S], windowed
// in float32, as z = frame_a + i frame_b in the buffer a (layout of fft).
// Returns, block-wide, bit 0 set when frame a has a non-zero sample and
// bit 1 when frame b has one.
__device__ int stage_pair(double* a, const float* __restrict__ x,
                          const float* __restrict__ win, long S, int n, int hop, int ta,
                          bool has_b) {
  const long s0 = (long)ta * hop - n / 2;
  const int np = padded(n);
  int nz = 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float w = win[i];
    const long s = s0 + i;
    float va = 0.f, vb = 0.f;
    if (s >= 0 && s < S) va = x[s] * w;
    if (has_b && s + hop >= 0 && s + hop < S) vb = x[s + hop] * w;
    a[pad(i)] = (double)va;
    a[np + pad(i)] = (double)vb;
    nz |= (va != 0.f ? 1 : 0) | (vb != 0.f ? 2 : 0);
  }
  const int any_a = __syncthreads_or(nz & 1);
  const int any_b = __syncthreads_or(nz & 2);
  return (any_a ? 1 : 0) | (any_b ? 2 : 0);
}

// Splits the pair's spectrum z (real parts at z[pad(k)], imaginary parts at
// zi[pad(k)]) and writes
// |X_a[k]|^power to dst[k * sk] and |X_b[k]|^power to dst[k * sk + sf] for
// k < bins; a frame flagged all-zero (bit clear in nz) gets exact zeros.
__device__ void split_pair(const double* z, const double* zi, int n, int bins, float power,
                           int nz, float* dst, int sk, int sf) {
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    const int k2 = k ? n - k : 0;
    const double pr = z[pad(k)], pi = zi[pad(k)], qr = z[pad(k2)], qi = zi[pad(k2)];
    dst[k * sk] = (nz & 1) ? power_of(0.5 * (pr + qr), 0.5 * (pi - qi), power) : 0.f;
    dst[k * sk + sf] = (nz & 2) ? power_of(0.5 * (pi + qi), 0.5 * (qr - pr), power) : 0.f;
  }
}

// split_pair straight to the output rows of stft_mag: frame a's bin k to
// dst[k * sk], frame b's to dst[k * sk + 1] when has_b.
__device__ void split_pair_out(const double* z, const double* zi, int n, int bins, float power,
                               int nz, float* __restrict__ dst, long sk, bool has_b) {
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    const int k2 = k ? n - k : 0;
    const double pr = z[pad(k)], pi = zi[pad(k)], qr = z[pad(k2)], qi = zi[pad(k2)];
    dst[k * sk] = (nz & 1) ? power_of(0.5 * (pr + qr), 0.5 * (pi - qi), power) : 0.f;
    if (has_b)
      dst[k * sk + 1] = (nz & 2) ? power_of(0.5 * (pi + qi), 0.5 * (qr - pr), power) : 0.f;
  }
}

// grid (ceil(n_frames / TF), B); out [B, bins, n_frames], bins = n/2 + 1
template <int TF>
__global__ void __launch_bounds__(FFT_THREADS, 1)
stft_mag_fft_kernel(const float* __restrict__ x, const float* __restrict__ win,
                    const double* __restrict__ cs, const double* __restrict__ sn,
                    const int* __restrict__ radix, int n_pass, float* __restrict__ out,
                    long T, int n, int hop, int n_frames, int bins, float power) {
  extern __shared__ double smem[];
  double* a = smem;                    // complex buffer, ping
  double* b = smem + 2 * padded(n);    // complex buffer, pong
  double* tw = smem + 4 * padded(n);   // two-level twiddle table
  float* tile = (float*)(tw + 2 * twiddle_rows(n));  // [bins, TF + 1] |X|^power
  const int sig = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const int nf = min(TF, n_frames - t0);
  const float* xs = x + (long)sig * T;
  load_twiddles(tw, n, cs, sn);
  for (int f = 0; f < nf; f += 2) {
    const int nz = stage_pair(a, xs, win, T, n, hop, t0 + f, f + 1 < nf);
    const double* z = fft(a, b, tw, n, radix, n_pass, cs, sn);
    split_pair(z, z + padded(n), n, bins, power, nz, tile + f, TF + 1, 1);
    __syncthreads();
  }
  float* o = out + (long)sig * bins * n_frames + t0;
  for (int i = threadIdx.x; i < bins * TF; i += blockDim.x) {
    const int k = i / TF;
    const int f = i - k * TF;
    if (f < nf) o[(long)k * n_frames + f] = tile[k * (TF + 1) + f];
  }
}

// grid (ceil(n_out / TF), n_windows); out [n_windows, n_mels, n_out]
template <int TF>
__global__ void __launch_bounds__(FFT_THREADS, 1)
stft_mel_fft_kernel(const float* __restrict__ x, const float* __restrict__ win,
                    const double* __restrict__ cs, const double* __restrict__ sn,
                    const int* __restrict__ radix, int n_pass, const float* __restrict__ fb,
                    const int* __restrict__ fb_lo, const int* __restrict__ fb_hi,
                    float* __restrict__ out, long S, int n, int hop, int n_out, int bins,
                    int n_mels, float power) {
  extern __shared__ double smem[];
  double* a = smem;
  double* b = smem + 2 * padded(n);
  double* tw = smem + 4 * padded(n);
  float* pw = (float*)(tw + 2 * twiddle_rows(n));  // [TF, bins] |X|^power
  const int w = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const int nf = min(TF, n_out - t0);
  const float* xs = x + (long)w * S;
  load_twiddles(tw, n, cs, sn);
  for (int f = 0; f < nf; f += 2) {
    const int nz = stage_pair(a, xs, win, S, n, hop, t0 + f, f + 1 < nf);
    const double* z = fft(a, b, tw, n, radix, n_pass, cs, sn);
    split_pair(z, z + padded(n), n, bins, power, nz, pw + f * bins, 1, bins);
    __syncthreads();
  }
  mel_epilogue(pw, fb, fb_lo, fb_hi, out, w, t0, nf, n_out, bins, n_mels);
}

// One-buffer routes. grid (ceil(n_frames / tf), B); out [B, bins, n_frames].
// tf (frames a block) is an argument here, not a template parameter: no loop
// is unrolled over it, and one instantiation a route keeps the build short.
template <int ROUTE>
__global__ void __launch_bounds__(FFT_THREADS, 1)
stft_mag_one_kernel(const float* __restrict__ x, const float* __restrict__ win, OneBuffer d,
                    float* __restrict__ out, long T, int n, int hop, int n_frames, int bins,
                    float power, int tf) {
  extern __shared__ double smem[];
  double* a = smem;                        // one complex buffer of d.m points
  double* tw = smem + 2 * padded(d.m);     // two-level twiddle table of d.m
  const int sig = blockIdx.y;
  const int t0 = blockIdx.x * tf;
  const int nf = min(tf, n_frames - t0);
  const float* xs = x + (long)sig * T;
  float* o = out + (long)sig * bins * n_frames + t0;
  load_twiddles(tw, d.m, d.cs, d.sn);
  for (int f = 0; f < nf; f += 2) {
    const bool has_b = f + 1 < nf;
    const int nz = stage_one<ROUTE>(a, xs, win, T, n, hop, t0 + f, has_b, d);
    transform_one<ROUTE>(a, tw, n, d);
    split_pair_out(a, a + padded(d.m), n, bins, power, nz, o + f, n_frames, has_b);
    __syncthreads();
  }
}

// One-buffer routes. grid (ceil(n_out / tf), n_windows); out
// [n_windows, n_mels, n_out]; tf as stft_mag_one_kernel's
template <int ROUTE>
__global__ void __launch_bounds__(FFT_THREADS, 1)
stft_mel_one_kernel(const float* __restrict__ x, const float* __restrict__ win, OneBuffer d,
                    const float* __restrict__ fb, const int* __restrict__ fb_lo,
                    const int* __restrict__ fb_hi, float* __restrict__ out, long S, int n,
                    int hop, int n_out, int bins, int n_mels, float power, int tf) {
  extern __shared__ double smem[];
  double* a = smem;
  double* tw = smem + 2 * padded(d.m);
  float* pw = (float*)(tw + 2 * twiddle_rows(d.m));  // [tf, bins] |X|^power
  const int w = blockIdx.y;
  const int t0 = blockIdx.x * tf;
  const int nf = min(tf, n_out - t0);
  const float* xs = x + (long)w * S;
  load_twiddles(tw, d.m, d.cs, d.sn);
  for (int f = 0; f < nf; f += 2) {
    const int nz = stage_one<ROUTE>(a, xs, win, S, n, hop, t0 + f, f + 1 < nf, d);
    transform_one<ROUTE>(a, tw, n, d);
    split_pair(a, a + padded(d.m), n, bins, power, nz, pw + f * bins, 1, bins);
    __syncthreads();
  }
  mel_epilogue(pw, fb, fb_lo, fb_hi, out, w, t0, nf, n_out, bins, n_mels);
}

// ---------------------------------------------------------------------------
// cluster route
// ---------------------------------------------------------------------------

// What the cluster route reads besides the signal and the window. The
// transform has N = c m points (n_fft, or a Bluestein length); block r of
// the cluster holds m of them in its one buffer.
struct Cluster {
  const double* cs;   // cos(2 pi j / N), j < N: the exchange's radix-c constants
  const double* sn;   // sin(2 pi j / N)
  const double* csm;  // cos(2 pi j / m), j < m: the block's passes
  const double* snm;
  const double* xc;   // [(c - 1) m] the exchange's twiddles by buffer address q:
  const double* xs;   //   cos/sin(2 pi k p(q) / N) at (k - 1) m + q, p(q) the point at q
  const int* radix;   // the plan of m
  int n_pass;
  int c;              // blocks a cluster: 2, 3, 4, 5, 7 or 8
  int m;              // points a block
  const int* perm;    // fft order: where local point i is staged (fft_positions of m)
  const double* chc;  // bluestein (null otherwise): the chirp, k < n_fft
  const double* chs;
  const double* bc;   // bluestein: the conjugate chirp's FFT over N, divided by N; bin
  const double* bs;   //   c k1 + r at r m + fft_positions(m)[k1]
};

// The exchange pass across the cluster, radix C, at this thread's buffer
// addresses q of the m (block rank's slice: q = rank * blockDim + tid,
// stride C blockDim), the same address in every block: consecutive
// threads take consecutive addresses, so the loads and stores, local and
// remote, hit distinct banks (the point p(q) at an address is the
// digit-reversed one where the block stages at fft_positions, and the
// host's twiddle table xc/xs is laid out by address to match). Decimation
// in frequency (DIT false): the C-point DFT over the blocks of (block r's
// point p), output k2 times W_N^{p k2}, into block k2's point p.
// Decimation in time (DIT true, the transpose): block r's point p times
// W_N^{r p}, then the C-point DFT, output k2 into block k2. Every point is
// read and written by one thread of the cluster, so the pass runs in place
// between two cluster barriers.
template <int C, bool DIT>
__device__ void exchange_c(double* a, const Cluster& d, int rank) {
  cg::cluster_group cl = cg::this_cluster();
  const int np = padded(d.m);
  double* rem[C];
#pragma unroll
  for (int r = 0; r < C; ++r) rem[r] = cl.map_shared_rank(a, r);
  double wc[C], ws[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    wc[q] = __ldg(d.cs + q * d.m);
    ws[q] = __ldg(d.sn + q * d.m);
  }
  for (int q = rank * blockDim.x + threadIdx.x; q < d.m; q += C * blockDim.x) {
    const int at = pad(q);
    double vr[C], vi[C];
#pragma unroll
    for (int r = 0; r < C; ++r) {
      vr[r] = rem[r][at];
      vi[r] = rem[r][np + at];
    }
    if (DIT) {
#pragma unroll
      for (int r = 1; r < C; ++r)
        twiddle(vr[r], vi[r], __ldg(d.xc + (r - 1) * d.m + q), __ldg(d.xs + (r - 1) * d.m + q));
    }
    butterfly<C>(vr, vi, wc, ws);
    if (!DIT) {
#pragma unroll
      for (int k = 1; k < C; ++k)
        twiddle(vr[k], vi[k], __ldg(d.xc + (k - 1) * d.m + q), __ldg(d.xs + (k - 1) * d.m + q));
    }
#pragma unroll
    for (int r = 0; r < C; ++r) {
      rem[r][at] = vr[r];
      rem[r][np + at] = vi[r];
    }
  }
}

template <bool DIT>
__device__ void exchange(double* a, const Cluster& d, int rank) {
  switch (d.c) {
    case 2: exchange_c<2, DIT>(a, d, rank); break;
    case 3: exchange_c<3, DIT>(a, d, rank); break;
    case 4: exchange_c<4, DIT>(a, d, rank); break;
    case 5: exchange_c<5, DIT>(a, d, rank); break;
    case 7: exchange_c<7, DIT>(a, d, rank); break;
    default: exchange_c<8, DIT>(a, d, rank); break;
  }
}

// Block rank stages its chunk of frames ta and ta + 1 (the second only
// when has_b): points j = rank m + i, windowed in float32, as
// z = frame_a + i frame_b; fft order at perm[i], bluestein times the chirp
// at i and zero past n. Returns, block-wide, the non-zero flags of its
// samples (bit 0: frame a, bit 1: frame b).
template <bool BLUE>
__device__ int stage_cluster(double* a, const float* __restrict__ x,
                             const float* __restrict__ win, long S, int n, int hop, int ta,
                             bool has_b, const Cluster& d, int rank) {
  const long s0 = (long)ta * hop - n / 2;
  const int np = padded(d.m);
  int nz = 0;
  for (int i = threadIdx.x; i < d.m; i += blockDim.x) {
    const int j = rank * d.m + i;
    double zr = 0.0, zi = 0.0;
    if (j < n) {
      float va, vb;
      frame_samples(x, win, S, s0 + j, hop, j, has_b, va, vb);
      nz |= (va != 0.f ? 1 : 0) | (vb != 0.f ? 2 : 0);
      zr = (double)va;
      zi = (double)vb;
      if (BLUE) twiddle(zr, zi, __ldg(d.chc + j), __ldg(d.chs + j));
    }
    const int at = BLUE ? i : __ldg(d.perm + i);
    a[pad(at)] = zr;
    a[np + pad(at)] = zi;
  }
  const int frame_a = __syncthreads_or(nz & 1) ? 1 : 0;
  const int frame_b = __syncthreads_or(nz & 2) ? 2 : 0;
  return frame_a | frame_b;
}

// Frames ta and ta + 1 staged and transformed across the cluster; returns
// the cluster's non-zero flags (stage_cluster's bits, or-ed over the
// blocks). fft order: the exchange by decimation in frequency, then the
// block's in-place passes (input at fft_positions, natural order out): bin
// k of the pair's spectrum Z ends in block k mod c at k / c. bluestein: the
// same exchange on natural order, the block's passes by decimation in
// frequency (bin c k1 + r in block r at fft_positions(m)[k1]), times the
// filter stored in that order and conjugated, the block's in-place passes
// (natural k1 out), the exchange by decimation in time: point k of the
// conjugate of the chirp product ends in block k / m at k mod m (cluster_z
// conjugates it and multiplies by the chirp). Ends on a cluster barrier.
template <bool BLUE>
__device__ int cluster_transform(double* a, const double* tw, int* flag,
                                 const float* __restrict__ x, const float* __restrict__ win,
                                 long S, int n, int hop, int ta, bool has_b, const Cluster& d,
                                 int rank) {
  cg::cluster_group cl = cg::this_cluster();
  const int own = stage_cluster<BLUE>(a, x, win, S, n, hop, ta, has_b, d, rank);
  if (threadIdx.x == 0) *flag = own;
  cl.sync();
  int nz = 0;
  for (int r = 0; r < d.c; ++r) nz |= *cl.map_shared_rank(flag, r);
  exchange<false>(a, d, rank);
  cl.sync();
  if constexpr (BLUE) {
    const int np = padded(d.m);
    fft_inplace_dif(a, tw, d.m, d.radix, d.n_pass, d.csm, d.snm);
    const double* bc = d.bc + (long)rank * d.m;
    const double* bs = d.bs + (long)rank * d.m;
    for (int p = threadIdx.x; p < d.m; p += blockDim.x) {
      const double xr = a[pad(p)], xi = a[np + pad(p)];
      const double br = __ldg(bc + p), bi = __ldg(bs + p);
      a[pad(p)] = fma(xr, br, -xi * bi);
      a[np + pad(p)] = -fma(xr, bi, xi * br);  // conjugated
    }
    __syncthreads();
    fft_inplace<false>(a, tw, d.m, d.radix, d.n_pass, d.csm, d.snm);
    cl.sync();
    exchange<true>(a, d, rank);
  } else {
    fft_inplace<true>(a, tw, d.m, d.radix, d.n_pass, d.csm, d.snm);
  }
  cl.sync();
  return nz;
}

// Bin k < n_fft of the pair's spectrum Z, read from the block that holds it
// (cluster_transform's layout).
template <bool BLUE>
__device__ __forceinline__ void cluster_z(const double* a, const Cluster& d, int k, double& zr,
                                          double& zi) {
  cg::cluster_group cl = cg::this_cluster();
  const int owner = BLUE ? k / d.m : k % d.c;
  const int i = BLUE ? k - owner * d.m : k / d.c;
  const double* b = cl.map_shared_rank(const_cast<double*>(a), owner);
  zr = b[pad(i)];
  zi = b[padded(d.m) + pad(i)];
  if (BLUE) {
    zi = -zi;  // conjugated, times the chirp
    twiddle(zr, zi, __ldg(d.chc + k), __ldg(d.chs + k));
  }
}

// split_pair over the cluster: block rank computes the bins
// k = rank + c i < bins, reading Z[k] and Z[n - k] from their blocks, and
// writes |X_a[k]|^power to dst[i * sk] and, when has_b, |X_b[k]|^power to
// dst[i * sk + sf]; a frame flagged all-zero gets exact zeros.
template <bool BLUE>
__device__ void split_cluster(const double* a, const Cluster& d, int n, int bins, float power,
                              int nz, int rank, float* dst, long sk, long sf, bool has_b) {
  for (int i = threadIdx.x;; i += blockDim.x) {
    const int k = rank + i * d.c;
    if (k >= bins) break;
    double pr, pi, qr, qi;
    cluster_z<BLUE>(a, d, k, pr, pi);
    cluster_z<BLUE>(a, d, k ? n - k : 0, qr, qi);
    dst[i * sk] = (nz & 1) ? power_of(0.5 * (pr + qr), 0.5 * (pi - qi), power) : 0.f;
    if (has_b)
      dst[i * sk + sf] = (nz & 2) ? power_of(0.5 * (pi + qi), 0.5 * (qr - pr), power) : 0.f;
  }
}

// mel_epilogue over the cluster: bin k's |X|^power of frame f lies in block
// k mod c's tile at [f][k / c] (rows of bpc); the cluster's threads take the
// outputs in turn (block rank's thread t: rank blockDim + t, stride c
// blockDim), each summed in bin order as mel_epilogue sums it.
__device__ void mel_cluster(const float* pw, int bpc, const float* __restrict__ fb,
                            const int* __restrict__ fb_lo, const int* __restrict__ fb_hi,
                            float* __restrict__ out, int w, int t0, int nf, int n_out, int bins,
                            int n_mels, int c, int rank) {
  cg::cluster_group cl = cg::this_cluster();
  float* tiles = const_cast<float*>(pw);
  for (int o = rank * blockDim.x + threadIdx.x; o < nf * n_mels; o += c * blockDim.x) {
    const int m = o / nf;
    const int f = o - m * nf;
    const float* row = fb + (long)m * bins;
    const int lo = fb_lo[m];
    int owner = lo % c, i = lo / c;
    double acc = 0.0;
    for (int k = lo; k < fb_hi[m]; ++k) {
      acc += (double)row[k] * (double)cl.map_shared_rank(tiles, owner)[f * bpc + i];
      if (++owner == c) {
        owner = 0;
        ++i;
      }
    }
    out[((long)w * n_mels + m) * n_out + t0 + f] = (float)acc;
  }
}

// grid (c ceil(n_frames / tf), B), clusters of (c, 1, 1); out
// [B, bins, n_frames]; tf frames a cluster.
template <bool BLUE>
__global__ void __launch_bounds__(FFT_THREADS, 1)
stft_mag_cluster_kernel(const float* __restrict__ x, const float* __restrict__ win, Cluster d,
                        float* __restrict__ out, long T, int n, int hop, int n_frames, int bins,
                        float power, int tf) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ double smem[];
  double* a = smem;                             // one complex buffer of m points
  double* tw = smem + 2 * padded(d.m);          // two-level twiddle table of m
  int* flag = (int*)(tw + 2 * twiddle_rows(d.m));  // this block's frame flags
  const int rank = (int)cl.block_rank();
  const int sig = blockIdx.y;
  const int t0 = (blockIdx.x / d.c) * tf;
  const int nf = min(tf, n_frames - t0);
  const float* xs = x + (long)sig * T;
  float* o = out + ((long)sig * bins + rank) * n_frames + t0;
  load_twiddles(tw, d.m, d.csm, d.snm);
  for (int f = 0; f < nf; f += 2) {
    const bool has_b = f + 1 < nf;
    const int nz =
        cluster_transform<BLUE>(a, tw, flag, xs, win, T, n, hop, t0 + f, has_b, d, rank);
    split_cluster<BLUE>(a, d, n, bins, power, nz, rank, o + f, (long)d.c * n_frames, 1, has_b);
    cl.sync();  // every block is done reading this pair before the next is staged
  }
}

// grid (c ceil(n_out / tf), n_windows), clusters of (c, 1, 1); out
// [n_windows, n_mels, n_out]; tf frames a cluster.
template <bool BLUE>
__global__ void __launch_bounds__(FFT_THREADS, 1)
stft_mel_cluster_kernel(const float* __restrict__ x, const float* __restrict__ win, Cluster d,
                        const float* __restrict__ fb, const int* __restrict__ fb_lo,
                        const int* __restrict__ fb_hi, float* __restrict__ out, long S, int n,
                        int hop, int n_out, int bins, int n_mels, float power, int tf) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ double smem[];
  double* a = smem;
  double* tw = smem + 2 * padded(d.m);
  int* flag = (int*)(tw + 2 * twiddle_rows(d.m));
  const int bpc = (bins + d.c - 1) / d.c;
  float* pw = (float*)(flag + 4);  // [tf, bpc] |X|^power of this block's bins
  const int rank = (int)cl.block_rank();
  const int w = blockIdx.y;
  const int t0 = (blockIdx.x / d.c) * tf;
  const int nf = min(tf, n_out - t0);
  const float* xs = x + (long)w * S;
  load_twiddles(tw, d.m, d.csm, d.snm);
  for (int f = 0; f < nf; f += 2) {
    const int nz = cluster_transform<BLUE>(a, tw, flag, xs, win, S, n, hop, t0 + f, f + 1 < nf,
                                           d, rank);
    split_cluster<BLUE>(a, d, n, bins, power, nz, rank, pw + f * bpc, 1, bpc, true);
    cl.sync();
  }
  mel_cluster(pw, bpc, fb, fb_lo, fb_hi, out, w, t0, nf, n_out, bins, n_mels, d.c, rank);
  cl.sync();  // no block exits while another reads its tile
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The current device's opt-in shared memory a block, queried once per device.
int max_smem_optin() {
  static std::mutex mu;
  static std::map<int, int> cache;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  auto found = cache.find(dev);
  if (found == cache.end()) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    found = cache.emplace(dev, v).first;
  }
  return found->second;
}

// Opts `kernel` in to `smem` bytes of dynamic shared memory, once per
// device, kernel and larger size.
cudaError_t allow_smem(const void* kernel, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> set;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem_optin()) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = set[{dev, kernel}];
  if (smem > have) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    have = smem;
  }
  return cudaSuccess;
}

// Shared memory of one block; ops/melspec.py :: stft_smem sizes it the same.
// The fft route's mag tile has a padded row of tf + 1 frames.
size_t fft_smem(int tf, int n_fft, int bins, bool mel) {
  return sizeof(double) * (4 * (size_t)padded(n_fft) + 2 * twiddle_rows(n_fft)) +
         sizeof(float) * (size_t)(mel ? tf : tf + 1) * bins;
}

// The one-buffer routes: one complex buffer and the table of m points (n_fft,
// or Bluestein's M), and stft_mel's [tf][bins] tile.
size_t one_smem(int tf, int m, int bins, bool mel) {
  return sizeof(double) * (2 * (size_t)padded(m) + 2 * twiddle_rows(m)) +
         (mel ? sizeof(float) * (size_t)tf * bins : 0);
}

// The cluster route's block (ops/melspec.py :: cluster_smem): one complex
// buffer and the table of its m points, 16 bytes of frame flags, and
// stft_mel's [tf][ceil(bins / c)] tile.
size_t cluster_smem(int tf, int c, int m, int bins, bool mel) {
  return sizeof(double) * (2 * (size_t)padded(m) + 2 * twiddle_rows(m)) + 16 +
         (mel ? sizeof(float) * (size_t)tf * ((bins + c - 1) / c) : 0);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t st,
                   Args... args) {
  const cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// The launch configuration of `kernel` in clusters of (c, 1, 1) blocks of
// FFT_THREADS threads; `attr` holds the cluster's size.
template <typename... Params>
cudaLaunchConfig_t cluster_config(void (*)(Params...), dim3 grid, int c, size_t smem,
                                  cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(FFT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of (c, 1, 1) blocks of `kernel` with `smem` bytes each
// the card holds at once (cudaOccupancyMaxActiveClusters), once per device,
// kernel, c and size; after opting the kernel in to `smem`.
template <typename... Params>
cudaError_t active_clusters(void (*kernel)(Params...), int c, size_t smem, int& clusters) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, size_t>, int> known;
  cudaError_t err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, (const void*)kernel, c, smem);
  auto found = known.find(key);
  if (found == known.end()) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(kernel, dim3(c), c, smem, 0, &attr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return err;
    found = known.emplace(key, n).first;
  }
  clusters = found->second;
  return cudaSuccess;
}

// Launches `kernel` in clusters of (c, 1, 1) blocks; cudaErrorInvalidValue
// when the smem can not be opted in to, cudaErrorNotSupported when the
// card can hold no such cluster.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int c, size_t smem,
                           cudaStream_t st, Args... args) {
  int clusters = 0;
  cudaError_t err = active_clusters(kernel, c, smem, clusters);
  if (err != cudaSuccess) return err;
  if (clusters <= 0) return cudaErrorNotSupported;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(kernel, grid, c, smem, st, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The cluster route's plan and tile checked: c one of 2, 3, 4, 5, 7, 8, m
// within the generic pass's held outputs, N = c m n_fft (fft order) or at
// least 2 n_fft - 1 (bluestein), tf 8 (stft_mag) or 8, 4, 2 (stft_mel).
bool cluster_ok(const Cluster& d, int n_fft, int tf, bool mel) {
  const bool c_ok = d.c == 2 || d.c == 3 || d.c == 4 || d.c == 5 || d.c == 7 || d.c == 8;
  const long pts = (long)d.c * d.m;
  const bool n_ok = d.chc ? pts >= 2L * n_fft - 1 && d.bc && d.bs && d.chs
                          : pts == n_fft && d.perm != nullptr;
  const bool tables_ok = d.xc && d.xs && d.csm && d.snm && d.cs && d.sn && d.radix;
  const bool tf_ok = mel ? (tf == 8 || tf == 4 || tf == 2) : tf == 8;
  return c_ok && n_ok && tables_ok && tf_ok && d.m > 0 && d.m <= HELD * FFT_THREADS;
}

// stft_mag on a one-buffer route (8 frames a block: it has no tile)
template <int ROUTE>
int mag_one(const float* x, const float* win, const OneBuffer& d, float* out, int B, long T,
            int n_fft, int hop, int n_frames, float power, int tf, void* stream) {
  if (B <= 0 || n_frames <= 0) return 0;
  if (B > 65535 || tf != 8 || (ROUTE == FFT1 && d.m > HELD * FFT_THREADS))
    return (int)cudaErrorInvalidValue;
  const int bins = n_fft / 2 + 1;
  const dim3 grid((n_frames + tf - 1) / tf, B);
  return (int)launch(stft_mag_one_kernel<ROUTE>, grid, FFT_THREADS,
                     one_smem(tf, d.m, bins, false), (cudaStream_t)stream, x, win, d, out, T,
                     n_fft, hop, n_frames, bins, power, tf);
}

// stft_mel on a one-buffer route (frames a block: 8, 4 or 2)
template <int ROUTE>
int mel_one(const float* x, const float* win, const OneBuffer& d, const float* fb,
            const int* fb_lo, const int* fb_hi, float* out, int n_windows, long S, int n_fft,
            int hop, int n_out, int bins, int n_mels, float power, int tf, void* stream) {
  if (n_windows <= 0 || n_out <= 0) return 0;
  if (n_windows > 65535 || bins <= 0 || bins > n_fft / 2 + 1 ||
      (tf != 8 && tf != 4 && tf != 2) || (ROUTE == FFT1 && d.m > HELD * FFT_THREADS))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_out + tf - 1) / tf, n_windows);
  return (int)launch(stft_mel_one_kernel<ROUTE>, grid, FFT_THREADS,
                     one_smem(tf, d.m, bins, true), (cudaStream_t)stream, x, win, d, fb, fb_lo,
                     fb_hi, out, S, n_fft, hop, n_out, bins, n_mels, power, tf);
}

}  // namespace

extern "C" {

// The shared memory a block may opt in to on the current device, in bytes.
int aat_smem_optin() { return max_smem_optin(); }

// fft route. x [B, T] float32; win [n_fft] float32; cs/sn [n_fft] float64
// (cos/sin of 2 pi j / n_fft); radix [n_pass] the passes, whose product is
// n_fft; out [B, n_fft/2 + 1, n_frames]; tf frames a block (8, 4 or 2).
int aat_stft_mag_fft(const float* x, const float* win, const double* cs, const double* sn,
                     const int* radix, int n_pass, float* out, int B, long T, int n_fft,
                     int hop, int n_frames, float power, int tf, void* stream) {
  if (B <= 0 || n_frames <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int bins = n_fft / 2 + 1;
  const size_t smem = fft_smem(tf, n_fft, bins, false);
  const dim3 grid((n_frames + tf - 1) / tf, B);
  switch (tf) {
    case 8: return (int)launch(stft_mag_fft_kernel<8>, grid, FFT_THREADS, smem, st, x, win, cs, sn, radix, n_pass, out, T, n_fft, hop, n_frames, bins, power);
    case 4: return (int)launch(stft_mag_fft_kernel<4>, grid, FFT_THREADS, smem, st, x, win, cs, sn, radix, n_pass, out, T, n_fft, hop, n_frames, bins, power);
    case 2: return (int)launch(stft_mag_fft_kernel<2>, grid, FFT_THREADS, smem, st, x, win, cs, sn, radix, n_pass, out, T, n_fft, hop, n_frames, bins, power);
    default: return (int)cudaErrorInvalidValue;
  }
}

// fft route. x [n_windows, S] float32; win, cs, sn, radix as above; fb
// [n_mels, bins] float32 with each row's nonzero support
// [fb_lo[m], fb_hi[m]); out [n_windows, n_mels, n_out] holds the first
// n_out frames of each window.
int aat_stft_mel_fft(const float* x, const float* win, const double* cs, const double* sn,
                     const int* radix, int n_pass, const float* fb, const int* fb_lo,
                     const int* fb_hi, float* out, int n_windows, long S, int n_fft, int hop,
                     int n_out, int bins, int n_mels, float power, int tf, void* stream) {
  if (n_windows <= 0 || n_out <= 0) return 0;
  if (n_windows > 65535 || bins <= 0 || bins > n_fft / 2 + 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = fft_smem(tf, n_fft, bins, true);
  const dim3 grid((n_out + tf - 1) / tf, n_windows);
  switch (tf) {
    case 8: return (int)launch(stft_mel_fft_kernel<8>, grid, FFT_THREADS, smem, st, x, win, cs, sn, radix, n_pass, fb, fb_lo, fb_hi, out, S, n_fft, hop, n_out, bins, n_mels, power);
    case 4: return (int)launch(stft_mel_fft_kernel<4>, grid, FFT_THREADS, smem, st, x, win, cs, sn, radix, n_pass, fb, fb_lo, fb_hi, out, S, n_fft, hop, n_out, bins, n_mels, power);
    case 2: return (int)launch(stft_mel_fft_kernel<2>, grid, FFT_THREADS, smem, st, x, win, cs, sn, radix, n_pass, fb, fb_lo, fb_hi, out, S, n_fft, hop, n_out, bins, n_mels, power);
    default: return (int)cudaErrorInvalidValue;
  }
}

// fft1 route: the fft route's arguments and perm [n_fft] int32, the
// position sample i is staged at; tf 8 (stft_mag) or 8, 4 or 2 (stft_mel).
int aat_stft_mag_fft1(const float* x, const float* win, const double* cs, const double* sn,
                      const int* radix, int n_pass, const int* perm, float* out, int B, long T,
                      int n_fft, int hop, int n_frames, float power, int tf, void* stream) {
  const OneBuffer d{cs, sn, radix, n_pass, n_fft, perm, nullptr, nullptr, nullptr, nullptr};
  return mag_one<FFT1>(x, win, d, out, B, T, n_fft, hop, n_frames, power, tf, stream);
}

int aat_stft_mel_fft1(const float* x, const float* win, const double* cs, const double* sn,
                      const int* radix, int n_pass, const int* perm, const float* fb,
                      const int* fb_lo, const int* fb_hi, float* out, int n_windows, long S,
                      int n_fft, int hop, int n_out, int bins, int n_mels, float power, int tf,
                      void* stream) {
  const OneBuffer d{cs, sn, radix, n_pass, n_fft, perm, nullptr, nullptr, nullptr, nullptr};
  return mel_one<FFT1>(x, win, d, fb, fb_lo, fb_hi, out, n_windows, S, n_fft, hop, n_out, bins,
                       n_mels, power, tf, stream);
}

// bluestein route: cs/sn [m] and radix [n_pass] the table and plan of the
// padded length m; chc/chs [n_fft] the chirp; bc/bs [m] its filter's
// spectrum in DIF order; the rest as the fft route's.
int aat_stft_mag_bluestein(const float* x, const float* win, const double* cs, const double* sn,
                           const int* radix, int n_pass, int m, const double* chc,
                           const double* chs, const double* bc, const double* bs, float* out,
                           int B, long T, int n_fft, int hop, int n_frames, float power, int tf,
                           void* stream) {
  const OneBuffer d{cs, sn, radix, n_pass, m, nullptr, chc, chs, bc, bs};
  return mag_one<BLUESTEIN>(x, win, d, out, B, T, n_fft, hop, n_frames, power, tf, stream);
}

int aat_stft_mel_bluestein(const float* x, const float* win, const double* cs, const double* sn,
                           const int* radix, int n_pass, int m, const double* chc,
                           const double* chs, const double* bc, const double* bs,
                           const float* fb, const int* fb_lo, const int* fb_hi, float* out,
                           int n_windows, long S, int n_fft, int hop, int n_out, int bins,
                           int n_mels, float power, int tf, void* stream) {
  const OneBuffer d{cs, sn, radix, n_pass, m, nullptr, chc, chs, bc, bs};
  return mel_one<BLUESTEIN>(x, win, d, fb, fb_lo, fb_hi, out, n_windows, S, n_fft, hop, n_out,
                            bins, n_mels, power, tf, stream);
}

// cluster route: cs/sn [c m] the table of the transform's N = c m points
// (n_fft, or a Bluestein length); radix [n_pass] the plan of m; perm [m]
// (fft order: where local point i is staged; null for bluestein); csm/snm
// [m] the table of m; xc/xs [(c - 1) m] the exchange's twiddles by buffer
// address; chc/chs [n_fft] and bc/bs [c m] Bluestein's chirp and its filter
// in the cluster's order (null for the fft order); tf 8.
int aat_stft_mag_cluster(const float* x, const float* win, const double* cs, const double* sn,
                         const int* radix, int n_pass, const int* perm, const double* csm,
                         const double* snm, const double* xc, const double* xs, int c, int m,
                         const double* chc, const double* chs, const double* bc, const double* bs,
                         float* out, int B, long T, int n_fft, int hop, int n_frames, float power,
                         int tf, void* stream) {
  if (B <= 0 || n_frames <= 0) return 0;
  const Cluster d{cs, sn, csm, snm, xc, xs, radix, n_pass, c, m, perm, chc, chs, bc, bs};
  const long tiles = (n_frames + tf - 1) / tf;
  if (B > 65535 || !cluster_ok(d, n_fft, tf, false) || tiles * c > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const int bins = n_fft / 2 + 1;
  const dim3 grid((unsigned)(tiles * c), B);
  const size_t smem = cluster_smem(tf, c, m, bins, false);
  const cudaStream_t st = (cudaStream_t)stream;
  if (chc)
    return (int)launch_cluster(stft_mag_cluster_kernel<true>, grid, c, smem, st, x, win, d, out,
                               T, n_fft, hop, n_frames, bins, power, tf);
  return (int)launch_cluster(stft_mag_cluster_kernel<false>, grid, c, smem, st, x, win, d, out, T,
                             n_fft, hop, n_frames, bins, power, tf);
}

// cluster route, stft_mel: the route's tables as aat_stft_mag_cluster's,
// the mel arguments as aat_stft_mel_fft's; tf 8, 4 or 2.
int aat_stft_mel_cluster(const float* x, const float* win, const double* cs, const double* sn,
                         const int* radix, int n_pass, const int* perm, const double* csm,
                         const double* snm, const double* xc, const double* xs, int c, int m,
                         const double* chc, const double* chs, const double* bc, const double* bs,
                         const float* fb, const int* fb_lo, const int* fb_hi, float* out,
                         int n_windows, long S, int n_fft, int hop, int n_out, int bins,
                         int n_mels, float power, int tf, void* stream) {
  if (n_windows <= 0 || n_out <= 0) return 0;
  const Cluster d{cs, sn, csm, snm, xc, xs, radix, n_pass, c, m, perm, chc, chs, bc, bs};
  const long tiles = (n_out + tf - 1) / tf;
  if (n_windows > 65535 || bins <= 0 || bins > n_fft / 2 + 1 || !cluster_ok(d, n_fft, tf, true) ||
      tiles * c > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles * c), n_windows);
  const size_t smem = cluster_smem(tf, c, m, bins, true);
  const cudaStream_t st = (cudaStream_t)stream;
  if (chc)
    return (int)launch_cluster(stft_mel_cluster_kernel<true>, grid, c, smem, st, x, win, d, fb,
                               fb_lo, fb_hi, out, S, n_fft, hop, n_out, bins, n_mels, power, tf);
  return (int)launch_cluster(stft_mel_cluster_kernel<false>, grid, c, smem, st, x, win, d, fb,
                             fb_lo, fb_hi, out, S, n_fft, hop, n_out, bins, n_mels, power, tf);
}

// The shared memory of one cluster block, in bytes (held against
// ops/melspec.py :: cluster_smem by a card test).
int aat_stft_cluster_smem(int tf, int c, int m, int bins, int mel) {
  return (int)cluster_smem(tf, c, m, bins, mel != 0);
}

// How many clusters of the route's kernel (stft_mel where mel, bluestein
// where blue) the card holds at once for that plan; a negative cudaError
// where the query fails.
int aat_stft_cluster_occupancy(int tf, int c, int m, int bins, int mel, int blue) {
  const size_t smem = cluster_smem(tf, c, m, bins, mel != 0);
  int n = 0;
  cudaError_t err;
  if (mel)
    err = blue ? active_clusters(stft_mel_cluster_kernel<true>, c, smem, n)
               : active_clusters(stft_mel_cluster_kernel<false>, c, smem, n);
  else
    err = blue ? active_clusters(stft_mag_cluster_kernel<true>, c, smem, n)
               : active_clusters(stft_mag_cluster_kernel<false>, c, smem, n);
  return err == cudaSuccess ? n : -(int)err;
}

}  // extern "C"
