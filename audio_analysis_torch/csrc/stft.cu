// Framed real DFT with a mel or a magnitude epilogue, for Hopper (sm_90a).
//
// stft_mel replaces the Pallas kernel audio_analysis_tpu/ops/pallas/melspec.py
// :: _kernel_dif (classify frontend, n_fft 4096 / hop 640 / 160 mels, and the
// end-scan, n_fft 4800 / hop 281 / 120 mels). stft_mag replaces
// melspec.py :: _kernel_dif_mag (detection |STFT|, n_fft 4096 / hop 281, all
// 1 + n_fft/2 bins in natural order, Nyquist included).
//
// What they compute, with librosa's conventions: frame t of a signal x[S] is
// x[t*hop - n_fft/2 .. t*hop + n_fft/2), zero outside [0, S) (centre framing
// with constant padding); it is multiplied by the periodic Hann window, and
// its real DFT X_k = sum_n x_n e^{-2 pi i k n / n_fft} is taken. stft_mag
// writes |X_k|^power as out[b][k][t]; stft_mel writes
// out[w][m][t] = sum_k fb[m][k] |X_k|^power over the first `bins` bins (the
// mel filterbank's support; the rest carry zero weight).
//
// Design (simple first): one block per (signal, tile of TF frames). The
// windowed frames (x * window in float32, as the plain version does) are
// staged in shared memory as float64 straight from the signal, by index,
// so no framed matrix ever exists in device memory. Each thread owns one
// DFT bin k at a time and walks n once for all TF frames. Its twiddle
// e^{-2 pi i k n / n_fft} advances by a float64 rotation per sample and is
// re-read exactly from a cos/sin table (built in float64 on the host, read
// through the cache) every RESYNC samples, which bounds the drift below
// 1e-13 relative. Products and sums are float64 FMAs: the median
// thresholds downstream consume raw bin magnitudes at a floor of 1e-3 of
// the maximum, where float32 arithmetic (an f32 FFT included) is off by
// 2-8e-5 relative, so the kernel matches an f64 oracle instead, for any
// n_fft (4096 = 2^12 and 4800 = 2^6 * 3 * 5^2 alike: no radix
// restriction). TF is the largest of 8/4/2/1 whose tile fits in shared
// memory. The mel projection reads the float32 power spectrum from shared
// memory and sums over each filter's nonzero support in float64. No
// atomics: every output is written once by one thread, so results do not
// change from run to run.
//
// What bounds it: as a function, the larger of its bytes (the PCM read
// once, the output written once, over 3.35 TB/s) and the operations of a
// real FFT computing it (2.5 n_fft log2 n_fft per frame, plus 2 per nonzero
// mel weight, over the 67 TFLOP/s float32 peak). stft_mag, which writes
// every bin, is bound by its bytes; stft_mel, whose mel output is small, by
// those operations (2-5x its bytes at the main path's shapes). This direct
// DFT does far more: 4 * bins * n_fft float64 flops per frame (plus the
// rotation's 4 per bin and sample, shared by the TF frames), and is bound
// by them. Left for later: the DFT as a tensor-core GEMM against
// Hann-folded DFT matrices (wgmma, with a split for float32 accuracy) or an
// FFT in shared memory, and TMA staging of the frames.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int RESYNC = 64;  // samples between exact twiddle reloads

template <int TF>
__device__ void stage_frames(double* fr, const float* __restrict__ x,
                             const float* __restrict__ win, long S, int n_fft,
                             int hop, int first_frame, int nf) {
  const int half = n_fft / 2;
  for (int i = threadIdx.x; i < TF * n_fft; i += blockDim.x) {
    const int f = i / n_fft;
    const int n = i - f * n_fft;
    float v = 0.f;
    if (f < nf) {
      const long s = (long)(first_frame + f) * hop + n - half;
      if (s >= 0 && s < S) v = x[s] * win[n];
    }
    fr[i] = (double)v;
  }
}

// Real DFT of bin k for TF staged frames, in float64. cs/sn hold
// cos/sin(2 pi j / n_fft) for j < n_fft.
template <int TF>
__device__ void dft_bin(const double* fr, const double* __restrict__ cs,
                        const double* __restrict__ sn, int n_fft, int k,
                        double (&re)[TF], double (&im)[TF]) {
#pragma unroll
  for (int f = 0; f < TF; ++f) re[f] = im[f] = 0.0;
  const double rc = cs[k], rs = sn[k];  // one step of the angle
  const int jump = (int)(((long)k * RESYNC) % n_fft);
  int idx = 0;  // (k * n0) mod n_fft at the start of each run
  for (int n0 = 0; n0 < n_fft; n0 += RESYNC) {
    double c = cs[idx], s = sn[idx];  // cos/sin of 2 pi k n / n_fft
    const int n1 = min(n0 + RESYNC, n_fft);
    for (int n = n0; n < n1; ++n) {
#pragma unroll
      for (int f = 0; f < TF; ++f) {
        const double v = fr[f * n_fft + n];
        re[f] = fma(v, c, re[f]);
        im[f] = fma(-v, s, im[f]);
      }
      const double c2 = fma(c, rc, -s * rs);  // angle += 2 pi k / n_fft
      s = fma(s, rc, c * rs);
      c = c2;
    }
    idx += jump;
    if (idx >= n_fft) idx -= n_fft;
  }
}

__device__ __forceinline__ float power_of(double re, double im, float power) {
  const double p2 = re * re + im * im;
  if (power == 2.f) return (float)p2;
  const double mag = sqrt(p2);
  if (power == 1.f) return (float)mag;
  return (float)pow(mag, (double)power);
}

// grid (ceil(n_out / TF), n_windows); out [n_windows, n_mels, n_out]
template <int TF>
__global__ void __launch_bounds__(THREADS)
stft_mel_kernel(const float* __restrict__ x, const float* __restrict__ win,
                const double* __restrict__ cs, const double* __restrict__ sn,
                const float* __restrict__ fb, const int* __restrict__ fb_lo,
                const int* __restrict__ fb_hi, float* __restrict__ out, long S,
                int n_fft, int hop, int n_out, int bins, int n_mels, float power) {
  extern __shared__ double smem[];
  double* fr = smem;                    // [TF, n_fft] windowed frames
  float* pw = (float*)(fr + TF * n_fft);  // [TF, bins] |X|^power
  const int w = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const int nf = min(TF, n_out - t0);
  stage_frames<TF>(fr, x + (long)w * S, win, S, n_fft, hop, t0, nf);
  __syncthreads();
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    double re[TF], im[TF];
    dft_bin<TF>(fr, cs, sn, n_fft, k, re, im);
#pragma unroll
    for (int f = 0; f < TF; ++f) pw[f * bins + k] = power_of(re[f], im[f], power);
  }
  __syncthreads();
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

// grid (ceil(n_frames / TF), B); out [B, n_bins, n_frames]
template <int TF>
__global__ void __launch_bounds__(THREADS)
stft_mag_kernel(const float* __restrict__ x, const float* __restrict__ win,
                const double* __restrict__ cs, const double* __restrict__ sn,
                float* __restrict__ out, long T, int n_fft, int hop,
                int n_frames, int n_bins, float power) {
  extern __shared__ double smem[];
  double* fr = smem;  // [TF, n_fft] windowed frames
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const int nf = min(TF, n_frames - t0);
  stage_frames<TF>(fr, x + (long)b * T, win, T, n_fft, hop, t0, nf);
  __syncthreads();
  for (int k = threadIdx.x; k < n_bins; k += blockDim.x) {
    double re[TF], im[TF];
    dft_bin<TF>(fr, cs, sn, n_fft, k, re, im);
    float* o = out + ((long)b * n_bins + k) * n_frames + t0;
#pragma unroll
    for (int f = 0; f < TF; ++f)
      if (f < nf) o[f] = power_of(re[f], im[f], power);
  }
}

int max_smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

template <int TF>
cudaError_t launch_mel(dim3 grid, size_t smem, cudaStream_t st, const float* x,
                       const float* win, const double* cs, const double* sn,
                       const float* fb, const int* lo, const int* hi, float* out,
                       long S, int n_fft, int hop, int n_out, int bins, int n_mels,
                       float power) {
  cudaFuncSetAttribute(stft_mel_kernel<TF>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  stft_mel_kernel<TF><<<grid, THREADS, smem, st>>>(
      x, win, cs, sn, fb, lo, hi, out, S, n_fft, hop, n_out, bins, n_mels, power);
  return cudaGetLastError();
}

template <int TF>
cudaError_t launch_mag(dim3 grid, size_t smem, cudaStream_t st, const float* x,
                       const float* win, const double* cs, const double* sn,
                       float* out, long T, int n_fft, int hop, int n_frames,
                       int n_bins, float power) {
  cudaFuncSetAttribute(stft_mag_kernel<TF>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  stft_mag_kernel<TF><<<grid, THREADS, smem, st>>>(
      x, win, cs, sn, out, T, n_fft, hop, n_frames, n_bins, power);
  return cudaGetLastError();
}

size_t mag_smem(int tf, int n_fft) {
  return sizeof(double) * (size_t)tf * n_fft;
}

size_t mel_smem(int tf, int n_fft, int bins) {
  return mag_smem(tf, n_fft) + sizeof(float) * (size_t)tf * bins;
}

}  // namespace

extern "C" {

// x [n_windows, S] float32; win [n_fft] float32; cs/sn [n_fft] float64
// (cos/sin of 2 pi j / n_fft); fb [n_mels, bins] float32 with each
// row's nonzero support [fb_lo[m], fb_hi[m]); out [n_windows, n_mels, n_out]
// holds the first n_out frames of each window.
int aat_stft_mel(const float* x, const float* win, const double* cs, const double* sn,
                 const float* fb, const int* fb_lo, const int* fb_hi, float* out,
                 int n_windows, long S, int n_fft, int hop, int n_out,
                 int bins, int n_mels, float power, void* stream) {
  if (n_windows <= 0 || n_out <= 0) return 0;
  if (n_windows > 65535 || bins <= 0 || bins > n_fft / 2 + 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t cap = (size_t)max_smem_optin();
  const int tfs[4] = {8, 4, 2, 1};
  for (int tf : tfs) {
    const size_t smem = mel_smem(tf, n_fft, bins);
    if (smem > cap) continue;
    const dim3 grid((n_out + tf - 1) / tf, n_windows);
    switch (tf) {
      case 8: return (int)launch_mel<8>(grid, smem, st, x, win, cs, sn, fb, fb_lo, fb_hi, out, S, n_fft, hop, n_out, bins, n_mels, power);
      case 4: return (int)launch_mel<4>(grid, smem, st, x, win, cs, sn, fb, fb_lo, fb_hi, out, S, n_fft, hop, n_out, bins, n_mels, power);
      case 2: return (int)launch_mel<2>(grid, smem, st, x, win, cs, sn, fb, fb_lo, fb_hi, out, S, n_fft, hop, n_out, bins, n_mels, power);
      default: return (int)launch_mel<1>(grid, smem, st, x, win, cs, sn, fb, fb_lo, fb_hi, out, S, n_fft, hop, n_out, bins, n_mels, power);
    }
  }
  return (int)cudaErrorInvalidConfiguration;  // n_fft too large for shared memory
}

// x [B, T] float32; win, cs, sn as above; out [B, n_fft/2 + 1, n_frames]
int aat_stft_mag(const float* x, const float* win, const double* cs, const double* sn,
                 float* out, int B, long T, int n_fft, int hop, int n_frames,
                 float power, void* stream) {
  if (B <= 0 || n_frames <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t cap = (size_t)max_smem_optin();
  const int n_bins = n_fft / 2 + 1;
  const int tfs[4] = {8, 4, 2, 1};
  for (int tf : tfs) {
    const size_t smem = mag_smem(tf, n_fft);
    if (smem > cap) continue;
    const dim3 grid((n_frames + tf - 1) / tf, B);
    switch (tf) {
      case 8: return (int)launch_mag<8>(grid, smem, st, x, win, cs, sn, out, T, n_fft, hop, n_frames, n_bins, power);
      case 4: return (int)launch_mag<4>(grid, smem, st, x, win, cs, sn, out, T, n_fft, hop, n_frames, n_bins, power);
      case 2: return (int)launch_mag<2>(grid, smem, st, x, win, cs, sn, out, T, n_fft, hop, n_frames, n_bins, power);
      default: return (int)launch_mag<1>(grid, smem, st, x, win, cs, sn, out, T, n_fft, hop, n_frames, n_bins, power);
    }
  }
  return (int)cudaErrorInvalidConfiguration;
}

}  // extern "C"
