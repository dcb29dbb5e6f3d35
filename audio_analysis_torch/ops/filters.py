"""IIR band-pass filtering (the JAX package's ops/filters.py).

The reference band-passes track audio with a scipy order-2 Butterworth SOS
filter (src/identify_tracks.py:1039-1056). The filter design runs on the
host in float64 (``butter_bandpass_sos`` and its helpers, copies of the JAX
package's). The application computes ``scipy.signal.sosfilt`` with zero
initial state in float32 on the tensor's device, as a doubling scan over
each section's affine state recurrence ``s[n+1] = A s[n] + g x[n]``:

- A = [[-a1, 1], [-a2, 0]] is the same at every sample, so step k of the
  scan needs only A^(2^k), which the host computes in float64;
- the scan carries only the offsets v (two [.., T] float32 arrays; the JAX
  package's ``associative_scan`` carries the four matrix entries too):
  v <- v + A^(2^k) v[n - 2^k], for 2^k < T;
- once every entry of a row's A^(2^k) is below 2^-60, every later step
  adds less than 2^-60 of its largest offset, far below float32's 2^-24:
  the row's later steps multiply by exact zeros, and the scan stops when
  every row has ended (before the powers reach float32's subnormal range,
  where CPUs slow down). The host decides this from the coefficients
  alone, so a row's result does not depend on the device or on the other
  rows of its stack.

The held reference is float64 scipy (tests/test_torch_filters.py): the
constant-matrix scan stays within 1e-3 of the output's scale there, where
the JAX package's float32 scan over products of per-step matrices is off by
up to 5.6e-3 of scale.
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from audio_analysis_torch.device import to_device_async


# ---------------------------------------------------------------------------
# Host-side Butterworth design (float64 numpy; no scipy dependency)
# ---------------------------------------------------------------------------


def _butter_analog_poles(order: int) -> np.ndarray:
    k = np.arange(-order + 1, order, 2)
    return -np.exp(1j * np.pi * k / (2 * order))


def _bilinear_zpk(z, p, k, fs):
    fs2 = 2.0 * fs
    z = np.asarray(z, dtype=complex)
    p = np.asarray(p, dtype=complex)
    degree = len(p) - len(z)
    z_d = (fs2 + z) / (fs2 - z)
    p_d = (fs2 + p) / (fs2 - p)
    z_d = np.append(z_d, -np.ones(degree))
    k_d = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    return z_d, p_d, k_d


def _poly_from_roots(roots: np.ndarray) -> np.ndarray:
    c = np.array([1.0 + 0j])
    for r in roots:
        c = np.convolve(c, np.array([1.0, -r]))
    return c


@lru_cache(maxsize=128)
def butter_bandpass_sos(lowcut: float, highcut: float, fs: float, order: int = 2) -> tuple:
    """Design a digital Butterworth filter as second-order sections.

    Mirrors the reference's design entry (src/identify_tracks.py:1039-1050):
    ``lowcut <= 0`` degrades to a low-pass at ``highcut``. Returns a tuple of
    ``(b0, b1, b2, a1, a2)`` float tuples (a0 normalised to 1).
    """
    nyq = 0.5 * fs
    fs_design = 2.0
    if lowcut > 0:
        wn = np.array([lowcut / nyq, highcut / nyq])
        warped = 2.0 * fs_design * np.tan(np.pi * wn / fs_design)
        bw = warped[1] - warped[0]
        wo = np.sqrt(warped[0] * warped[1])
        p_lp = _butter_analog_poles(order)
        k = 1.0
        # lp2bp
        p_scaled = p_lp * bw / 2.0
        p_bp = np.concatenate(
            [
                p_scaled + np.sqrt(p_scaled**2 - wo**2),
                p_scaled - np.sqrt(p_scaled**2 - wo**2),
            ]
        )
        z_bp = np.zeros(order)
        k_bp = k * bw**order
        z, p, kd = _bilinear_zpk(z_bp, p_bp, k_bp, fs_design)
        # Pair conjugate pole pairs with zeros scipy-style (zpk2sos
        # 'nearest'): process poles closest to the unit circle first, give
        # each pair the two nearest available zeros (all zeros are at +/-1
        # for a Butterworth bandpass), then order sections low-Q first with
        # the overall gain folded into the first output section.
        p_pos = sorted(p[np.imag(p) >= 0], key=lambda q: -abs(q))
        zero_pool = [1.0] * order + [-1.0] * order
        sections = []
        for pp in p_pos:
            den = np.real(_poly_from_roots(np.array([pp, np.conj(pp)])))
            zz = []
            for _ in range(2):
                zv = min(zero_pool, key=lambda v: abs(v - pp))
                zero_pool.remove(zv)
                zz.append(zv)
            num = np.real(_poly_from_roots(np.asarray(zz, dtype=complex)))
            sections.append(
                (num[0], num[1], num[2], den[1] / den[0], den[2] / den[0])
            )
        sections = sections[::-1]
        first = sections[0]
        sections[0] = (first[0] * kd, first[1] * kd, first[2] * kd, first[3], first[4])
    else:
        wn = highcut / nyq
        warped = 2.0 * fs_design * np.tan(np.pi * wn / fs_design)
        p_lp = _butter_analog_poles(order) * warped
        k = warped**order
        z, p, kd = _bilinear_zpk(np.array([]), p_lp, k, fs_design)
        p_pos = sorted(p[np.imag(p) >= 0], key=lambda q: -abs(q))
        sections = []
        gain = kd
        zeros_iter = list(z)
        for pp in p_pos:
            den = np.real(_poly_from_roots(np.array([pp, np.conj(pp)])))
            zz = zeros_iter[:2]
            zeros_iter = zeros_iter[2:]
            num = np.real(_poly_from_roots(np.asarray(zz, dtype=complex))) * gain
            gain = 1.0
            if len(num) < 3:
                num = np.concatenate([num, np.zeros(3 - len(num))])
            sections.append(
                (num[0], num[1], num[2], den[1] / den[0], den[2] / den[0])
            )
    return tuple(tuple(float(c) for c in s) for s in sections)


# ---------------------------------------------------------------------------
# Application: the doubling scan
# ---------------------------------------------------------------------------

_NEGLIGIBLE = 2.0**-60  # A^(2^k) below this in every entry ends a row's scan


def _section_scan(x: torch.Tensor, c: np.ndarray) -> torch.Tensor:
    """One direct-form-II-transposed section along the last axis of x
    (zero initial state). ``c`` is [R, 5] float64 (b0, b1, b2, a1, a2), one
    row per row of x's second-to-last axis, or [1, 5] for all rows:

        y[n]  = b0 x[n] + s1[n]
        s[n+1] = A s[n] + g x[n],  A = [[-a1, 1], [-a2, 0]],
                                   g = (b1 - a1 b0, b2 - a2 b0).
    """
    t = x.shape[-1]
    shape = (len(c), 1) if len(c) > 1 else (1,)  # one value a row, or one for all
    b0, b1, b2, a1, a2 = c.T
    # the host's coefficients, one copy to the device: b0, g, then the
    # entries of A^(2^k) for every step the scan takes (a row's end: 0)
    host = [b0, b1 - a1 * b0, b2 - a2 * b0]
    a = np.zeros((len(c), 2, 2))
    a[:, 0, 0], a[:, 0, 1], a[:, 1, 0] = -a1, 1.0, -a2
    d = 1
    while d < t:
        live = np.abs(a).max(axis=(1, 2)) >= _NEGLIGIBLE
        if not live.any():
            break
        m = np.where(live[:, None, None], a, 0.0)
        host += [m[:, i, j] for i in (0, 1) for j in (0, 1)]
        a = a @ a
        d *= 2
    coef = to_device_async(torch.from_numpy(np.stack(host).astype(np.float32)), x.device)
    col = lambda i: coef[i].reshape(shape)

    u1, u2 = col(1) * x, col(2) * x  # v after 0 steps: g x[n]
    for k in range((len(host) - 3) // 4):
        d = 1 << k
        m11, m12, m21, m22 = (col(3 + 4 * k + i) for i in range(4))
        p1, p2 = u1[..., :-d], u2[..., :-d]
        n1, n2 = u1.clone(), u2.clone()
        n1[..., d:] += m11 * p1 + m12 * p2
        n2[..., d:] += m21 * p1 + m22 * p2
        u1, u2 = n1, n2
    # u1[n] is s1[n+1], the state after sample n
    return col(0) * x + F.pad(u1[..., :-1], (1, 0))


def sosfilt_array(sos, x: torch.Tensor) -> torch.Tensor:
    """scipy.signal.sosfilt along the last axis (zero initial state), in
    float32 on x's device. ``sos`` is [n_sections, 5] for every row, or
    [R, n_sections, 5] with one filter per row of x [.., R, T] (per-track
    band-passes over a padded track stack; pad with identity sections
    (1, 0, 0, 0, 0)). Coefficient layout (b0, b1, b2, a1, a2), held on the
    host."""
    sos = np.asarray(sos, np.float64)
    if sos.ndim == 2:
        sos = sos[None]
    y = x.to(torch.float32)
    for i in range(sos.shape[-2]):
        y = _section_scan(y, sos[:, i, :])
    return y


def sosfilt(sos, x: torch.Tensor) -> torch.Tensor:
    """Cascaded second-order sections ``sos`` ((b0, b1, b2, a1, a2), ...)
    along the last axis (reference: src/identify_tracks.py:1053-1056)."""
    return sosfilt_array(sos, x)

