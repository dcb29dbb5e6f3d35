"""The port's masked medians (audio_analysis_torch.ops.medians) are
bit-identical to np.median, to the JAX XLA rank search
(detect/signal_noise.py::_masked_medians_rowcol) and to the Pallas kernels
(ops/pallas/medians.py, interpret mode). On a CPU tensor the wrappers take
their plain version (a sort); tests/test_torch_kernels.py holds the kernels
to it on a GPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_analysis_tpu.detect.signal_noise import _masked_medians_rowcol
from audio_analysis_tpu.ops.pallas.medians import pallas_masked_medians_rowcol

from audio_analysis_torch.ops import medians as md


def _spec(rng, kind, bins, t):
    if kind == "ties":  # few distinct values: many equal middles
        return (rng.randint(0, 4, size=(bins, t)) * 0.25).astype(np.float32)
    if kind == "zeros":  # mostly exact zeros, as digital silence gives
        x = np.abs(rng.randn(bins, t)).astype(np.float32)
        x[rng.rand(bins, t) < 0.7] = 0.0
        return x
    return (np.abs(rng.randn(bins, t)) ** 3).astype(np.float32)


def _np_medians(spec, nvf):
    row = np.median(spec[:, :nvf], axis=1)
    col = np.median(spec, axis=0)
    return row.astype(np.float32), col.astype(np.float32)


CASES = [  # (kind, bins, T, nvf): odd/even counts both ways, nvf < T and == T
    ("random", 37, 50, 50),
    ("random", 38, 51, 33),
    ("ties", 41, 64, 64),
    ("ties", 40, 60, 21),
    ("zeros", 33, 45, 44),
    ("zeros", 34, 45, 1),
]


@pytest.mark.parametrize("kind,bins,t,nvf", CASES)
def test_plain_medians_bit_identical(rng, kind, bins, t, nvf):
    spec = _spec(rng, kind, bins, t)
    row, col = md.masked_medians_rowcol(torch.from_numpy(spec)[None], torch.tensor([nvf]))
    row, col = row.numpy()[0, :, 0], col.numpy()[0, 0]
    np_row, np_col = _np_medians(spec, nvf)
    np.testing.assert_array_equal(row.view(np.int32), np_row.view(np.int32))
    np.testing.assert_array_equal(col.view(np.int32), np_col.view(np.int32))

    col_valid = jnp.arange(t) < nvf
    x_row, x_col = _masked_medians_rowcol(jnp.asarray(spec), col_valid, nvf, bins)
    np.testing.assert_array_equal(row, np.asarray(x_row)[:, 0])
    np.testing.assert_array_equal(col[:nvf], np.asarray(x_col)[0, :nvf])

    p_row, p_col = pallas_masked_medians_rowcol(
        jnp.asarray(spec)[None], jnp.asarray([nvf]), interpret=True
    )
    np.testing.assert_array_equal(row, np.asarray(p_row)[0, :, 0])
    np.testing.assert_array_equal(col[:nvf], np.asarray(p_col)[0, 0, :nvf])


def test_plain_medians_batch_rows_use_their_own_nvf(rng):
    spec = np.stack([_spec(rng, "random", 20, 30) for _ in range(3)])
    nvf = [30, 11, 2]
    row, col = md.masked_medians_rowcol(torch.from_numpy(spec), torch.tensor(nvf))
    for b in range(3):
        np_row, np_col = _np_medians(spec[b], nvf[b])
        np.testing.assert_array_equal(row[b, :, 0].numpy(), np_row)
        np.testing.assert_array_equal(col[b, 0].numpy(), np_col)


def test_torch_median_is_not_np_median():
    """Why the port carries its own medians: torch.median returns the lower
    middle value where np.median averages the two."""
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    assert float(torch.median(x)) == 2.0
    assert float(md.col_medians(x[:, None][None])[0, 0, 0]) == float(np.median(x.numpy())) == 2.5
