// Native host encoder for the PCM wire codec (io/pcmcodec.py).
//
// The TPU-side decoder unpacks fixed-width zigzag residual blocks (kBlock
// samples each); this file is the host half: compute order-1/2/3 linear
// prediction residuals, pick the cheapest order, and bit-pack each block at
// its own width. Pure numpy is ~100x too slow for this on the single-core
// serving hosts (measured 6.5 s for a 46 MB batch; the wire it feeds moves
// that batch in ~1 s), hence C++. The layout contract (MSB-first words,
// (kBlock/32)*w words per block, zigzag, implicit-zero warmup so the decoder is a
// plain cumsum^order) is shared with io/pcmcodec.py's numpy fallback and
// pinned by tests/test_pcmcodec.py.
//
// The residuals are direct finite differences of the input —
//   r0[i] = x[i]                                        (no prediction)
//   r1[i] = x[i] - x[i-1]
//   r2[i] = x[i] - 2 x[i-1] + x[i-2]
//   r3[i] = x[i] - 3 x[i-1] + 3 x[i-2] - x[i-3]        (x[<row start] = 0)
// — written with direct array indexing (NOT a carried previous-sample
// state) so gcc auto-vectorizes the width scan; the serving hosts have one
// core, so SIMD is the only parallelism available. Order 0 matters for
// noise-dominated field recordings: differencing near-white noise DOUBLES
// its variance (one whole bit per sample), so "no predictor" wins there.
//
// Built on demand via native/__init__.py (g++ -O3 -march=native), ctypes.

#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t kBlock = 256;

inline uint32_t zigzag(int32_t v) {
  return (static_cast<uint32_t>(v) << 1) ^ static_cast<uint32_t>(v >> 31);
}

inline int width_of(uint32_t maxz) {
  if (maxz == 0) return 0;
  const int w = 32 - __builtin_clz(maxz);
  // exact width up to the 20-bit order<=3 zigzag maximum (io/pcmcodec.
  // _WIDTHS); 32 is an unreachable defensive escape. The old coarse
  // palette (steps of 2) cost 2.7% extra wire on the bench batch; exact
  // widths are affordable since the decode runs one program per tier.
  return w <= 20 ? w : 32;
}

inline uint32_t umax(uint32_t a, uint32_t b) { return a > b ? a : b; }

inline int32_t residual_at(const int16_t* x, int64_t row, int64_t j,
                           int order) {
  const int32_t x0 = x[j];
  const int32_t x1 = (j - 1 >= row) ? x[j - 1] : 0;
  if (order == 0) return x0;
  if (order == 1) return x0 - x1;
  const int32_t x2 = (j - 2 >= row) ? x[j - 2] : 0;
  if (order == 2) return x0 - 2 * x1 + x2;
  const int32_t x3 = (j - 3 >= row) ? x[j - 3] : 0;
  return x0 - 3 * x1 + 3 * x2 - x3;
}

// order-specialised block packer; residuals by direct differencing.
// Values are masked to w bits: with pFOR exceptions (pcm_pfor below) a
// block may contain samples wider than its width — the packed low bits are
// placeholders the decoder's exception scatter overwrites, and the full
// zigzag values are emitted to (epos, eval) here (pack already touches
// every sample, so exception extraction is free). Returns the exception
// count written. w == 0 packs no words but still emits exceptions.
template <int kOrder>
inline int64_t pack_block(const int16_t* x, int64_t row, int64_t s, int w,
                          uint32_t* out, int32_t* epos, uint32_t* eval) {
  uint64_t acc = 0;
  int nbits = 0;
  int64_t ne = 0;
  const uint32_t mask =
      w >= 32 ? 0xffffffffu : ((uint32_t(1) << w) - 1);
  for (int64_t i = 0; i < kBlock; ++i) {
    const int64_t j = s + i;
    const int32_t x0 = x[j];
    const int32_t x1 = (j - 1 >= row) ? x[j - 1] : 0;
    int32_t r;
    if (kOrder == 0) {
      r = x0;
    } else if (kOrder == 1) {
      r = x0 - x1;
    } else if (kOrder == 2) {
      const int32_t x2 = (j - 2 >= row) ? x[j - 2] : 0;
      r = x0 - 2 * x1 + x2;
    } else {
      const int32_t x2 = (j - 2 >= row) ? x[j - 2] : 0;
      const int32_t x3 = (j - 3 >= row) ? x[j - 3] : 0;
      r = x0 - 3 * x1 + 3 * x2 - x3;
    }
    const uint32_t z = zigzag(r);
    if (z > mask) {
      epos[ne] = static_cast<int32_t>(j);
      eval[ne] = z;
      ++ne;
    }
    acc = (acc << w) | (z & mask);
    nbits += w;
    while (nbits >= 32) {
      *out++ = static_cast<uint32_t>(acc >> (nbits - 32));
      nbits -= 32;
      acc &= (nbits ? ((uint64_t(1) << nbits) - 1) : 0);
    }
  }
  return ne;
}

}  // namespace

extern "C" {

// Per-block widths for orders 0..3. x is [B, T] row-major int16, T % kBlock
// == 0. widths_out is [4, n_blocks] (order-0 row first). Returns n_blocks.
int64_t pcm_widths(const int16_t* x, int64_t B, int64_t T,
                   uint8_t* widths_out) {
  const int64_t nb_row = T / kBlock;
  const int64_t n_blocks = B * nb_row;
  for (int64_t b = 0; b < B; ++b) {
    const int64_t row = b * T;
    for (int64_t k = 0; k < nb_row; ++k) {
      const int64_t s = row + k * kBlock;
      uint32_t m0 = 0, m1 = 0, m2 = 0, m3 = 0;
      if (k == 0) {
        // row start: guard the first 3 samples' out-of-row reads
        for (int64_t i = 0; i < 3; ++i) {
          const int32_t x0 = x[s + i];
          const int32_t x1 = i >= 1 ? x[s + i - 1] : 0;
          const int32_t x2 = i >= 2 ? x[s + i - 2] : 0;
          m0 = umax(m0, zigzag(x0));
          m1 = umax(m1, zigzag(x0 - x1));
          m2 = umax(m2, zigzag(x0 - 2 * x1 + x2));
          m3 = umax(m3, zigzag(x0 - 3 * x1 + 3 * x2));
        }
      } else {
        for (int64_t i = 0; i < 3; ++i) {
          const int32_t x0 = x[s + i], x1 = x[s + i - 1], x2 = x[s + i - 2],
                        x3 = x[s + i - 3];
          m0 = umax(m0, zigzag(x0));
          m1 = umax(m1, zigzag(x0 - x1));
          m2 = umax(m2, zigzag(x0 - 2 * x1 + x2));
          m3 = umax(m3, zigzag(x0 - 3 * x1 + 3 * x2 - x3));
        }
      }
      // vectorizable main scan: pure direct loads, no carried state
      for (int64_t i = 3; i < kBlock; ++i) {
        const int32_t x0 = x[s + i], x1 = x[s + i - 1], x2 = x[s + i - 2],
                      x3 = x[s + i - 3];
        m0 = umax(m0, zigzag(x0));
        m1 = umax(m1, zigzag(x0 - x1));
        m2 = umax(m2, zigzag(x0 - 2 * x1 + x2));
        m3 = umax(m3, zigzag(x0 - 3 * x1 + 3 * x2 - x3));
      }
      const int64_t kk = b * nb_row + k;
      widths_out[kk] = static_cast<uint8_t>(width_of(m0));
      widths_out[n_blocks + kk] = static_cast<uint8_t>(width_of(m1));
      widths_out[2 * n_blocks + kk] = static_cast<uint8_t>(width_of(m2));
      widths_out[3 * n_blocks + kk] = static_cast<uint8_t>(width_of(m3));
    }
  }
  return n_blocks;
}

// Patched-FOR width lowering for the CHOSEN order. widths[kk] holds the
// max-based (exception-free) block widths on entry; on exit it holds the
// cost-optimal width w minimizing 8*w + 2*count(need > w) words — each
// exception costs 2 wire words (int32 flat position + int32 zigzag value),
// each width bit costs kBlock/32 = 8 words. exc_out[kk] gets the block's
// exception count. Returns the total exception count. Measured on the
// bench batch: wire ratio 0.745 -> 0.722 (order-0 entropy floor 0.690).
int64_t pcm_pfor(const int16_t* x, int64_t B, int64_t T, int32_t order,
                 uint8_t* widths, int32_t* exc_out) {
  const int64_t nb_row = T / kBlock;
  int64_t total = 0;
  for (int64_t b = 0; b < B; ++b) {
    const int64_t row = b * T;
    for (int64_t k = 0; k < nb_row; ++k) {
      const int64_t kk = b * nb_row + k;
      const int w0 = widths[kk];
      exc_out[kk] = 0;
      if (w0 == 0 || w0 > 20) continue;  // silence / defensive escape
      const int64_t s = row + k * kBlock;
      // zigzag residuals into a buffer (vectorizable: direct loads, no
      // branches past the 3-sample row-start guard), then histogram needs
      uint32_t zbuf[kBlock];
      const int64_t guard = (k == 0) ? 3 : 0;
      for (int64_t i = 0; i < guard; ++i)
        zbuf[i] = zigzag(residual_at(x, row, s + i, order));
      if (order == 0) {
        for (int64_t i = guard; i < kBlock; ++i) zbuf[i] = zigzag(x[s + i]);
      } else if (order == 1) {
        for (int64_t i = guard; i < kBlock; ++i)
          zbuf[i] = zigzag(x[s + i] - x[s + i - 1]);
      } else if (order == 2) {
        for (int64_t i = guard; i < kBlock; ++i)
          zbuf[i] = zigzag(x[s + i] - 2 * x[s + i - 1] + x[s + i - 2]);
      } else {
        for (int64_t i = guard; i < kBlock; ++i)
          zbuf[i] = zigzag(x[s + i] - 3 * x[s + i - 1] + 3 * x[s + i - 2] -
                           x[s + i - 3]);
      }
      // hist[n] = #samples needing exactly n bits
      int32_t hist[21] = {0};
      for (int64_t i = 0; i < kBlock; ++i) {
        const uint32_t z = zbuf[i];
        hist[z == 0 ? 0 : 32 - __builtin_clz(z)]++;
      }
      // exc(w) = #samples needing > w bits, scanned from the top; pick the
      // words-cost argmin (ties -> larger width = fewer exceptions)
      int best_w = w0;
      int64_t best_cost = int64_t(8) * w0;  // exc(w0) == 0 by construction
      int32_t exc = 0, best_exc = 0;
      for (int w = w0 - 1; w >= 0; --w) {
        exc += hist[w + 1];
        const int64_t cost = int64_t(8) * w + int64_t(2) * exc;
        if (cost < best_cost) {
          best_cost = cost;
          best_w = w;
          best_exc = exc;
        }
      }
      widths[kk] = static_cast<uint8_t>(best_w);
      exc_out[kk] = best_exc;
      total += best_exc;
    }
  }
  return total;
}

// Pack residuals of `order` at per-block (pFOR-lowered) widths into
// words_out: block k's (kBlock/32)*widths[k] MSB-first words start at
// word_offs[k] (prefix sums computed by the caller). Exception (flat
// position, zigzag value) pairs are emitted to exc_pos/exc_val in block
// order (caller sizes them from pcm_pfor's total; exc_counts gates the
// scan of width-0 silence blocks). Returns the exception count written.
int64_t pcm_pack(const int16_t* x, int64_t B, int64_t T, int32_t order,
                 const uint8_t* widths, const int64_t* word_offs,
                 uint32_t* words_out, const int32_t* exc_counts,
                 int32_t* exc_pos, uint32_t* exc_val) {
  const int64_t nb_row = T / kBlock;
  int64_t n_exc = 0;
  for (int64_t b = 0; b < B; ++b) {
    const int64_t row = b * T;
    for (int64_t k = 0; k < nb_row; ++k) {
      const int64_t kk = b * nb_row + k;
      const int w = widths[kk];
      if (w == 0 && exc_counts[kk] == 0) continue;
      const int64_t s = row + k * kBlock;
      uint32_t* out = words_out + word_offs[kk];
      int32_t* epos = exc_pos + n_exc;
      uint32_t* eval = exc_val + n_exc;
      switch (order) {
        case 0:
          n_exc += pack_block<0>(x, row, s, w, out, epos, eval);
          break;
        case 1:
          n_exc += pack_block<1>(x, row, s, w, out, epos, eval);
          break;
        case 2:
          n_exc += pack_block<2>(x, row, s, w, out, epos, eval);
          break;
        default:
          n_exc += pack_block<3>(x, row, s, w, out, epos, eval);
      }
    }
  }
  return n_exc;
}

}  // extern "C"
