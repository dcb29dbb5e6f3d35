"""The counters against hand counts: MACs from layer shapes, FFT
operations, the rooflines' bytes, and the Keras weight groups against the
archive's datasets."""

import json
import math
import zipfile

import pytest
from conftest import BENCH

from benchlib import counts, h5read, spec
from benchlib.fixtures import keras_groups
from benchref import dsp, effnet, tuinet


def test_efficientnet_b0_macs_published():
    # Tan & Le, table 2: 0.39B FLOPs (multiply-adds) at 224 x 224 x 3, 1000 classes
    assert effnet.macs(224, 224, 1000) == pytest.approx(0.39e9, rel=0.02)


def test_tuinet_macs_by_hand():
    h, w = 80, 113  # the stem's stride 2 over [160, 226]
    hand = h * w * 9 * 32
    hand += 80 * 113 * 9 * (32 * 64 + 64 * 64)
    hand += 40 * 57 * 9 * (64 * 128 + 128 * 128)
    hand += 20 * 29 * 9 * (128 * 256 + 256 * 256)
    hand += 256 * 256 + 256 * 8
    assert tuinet.macs(160, 226, [64, 128, 256], 32, 256, 8) == hand
    assert hand == pytest.approx(1.52e9, rel=0.01)


def test_fft_flops_by_hand():
    assert dsp.fft_flops(4096) == 2.5 * 4096 * 12
    assert dsp.fft_flops(4800) == pytest.approx(2.5 * 4800 * math.log2(4800))


def test_detection_flops_by_hand():
    samples = 60 * 48000
    mag = (1 + samples // 281) * 2.5 * 4096 * 12
    chunk = 48000 // 281
    frames = ((1 + samples // 281) // chunk) * chunk
    nnz = counts.mel_nonzeros(4800, 120, 50.0, 11000.0, 1750.0)
    assert frames == 10200 and 1 + samples // 281 == 10250
    assert counts.detection_flops(samples) == mag + frames * (dsp.fft_flops(4800) + 2 * nnz)


def test_roofline_bytes_by_hand():
    mag = spec.load_metric("stft_mag_roofline")
    ops, nbytes = mag.work(8, 2_880_000)
    assert nbytes == 4 * 8 * 2_880_000 + 4 * 8 * 2049 * 10250
    assert ops == 8 * 10250 * 2.5 * 4096 * 12
    med = spec.load_metric("medians_roofline")
    assert med.bytes_moved(1, 2_880_000) == 2 * 4 * 2049 * 10250 + 4 * (2049 + 10250)


def test_window_count_from_a_result():
    cfg = json.loads((BENCH / "configs/effnetb0.json").read_text())
    result = {"species_identify": [{"begin_s": 1.0, "end_s": 2.0, "freq_start": 1000.0,
                                    "freq_end": 3000.0},
                                   {"begin_s": 10.0, "end_s": 16.0, "freq_start": 500.0,
                                    "freq_end": 900.0},
                                   {"begin_s": 20.0, "end_s": 21.0, "freq_start": 12000.0,
                                    "freq_end": 15000.0}]}  # out of band: no window
    # 1 s track: one window; 6 s track: windows at 0, 1.5 and 3.0 s (the next would end
    # at 7.5 s, past the track)
    assert counts.windows_of(result, 60 * 48000, cfg) == 1 + 3


def test_keras_groups_match_the_archive():
    cfg = json.loads((BENCH / "configs/effnetb0.json").read_text())
    zero = BENCH.parent / cfg["models"][0]["archive"]
    with zipfile.ZipFile(zero) as z:
        groups = keras_groups(json.loads(z.read("config.json")))
        tree = h5read.read_h5(z.read("model.weights.h5"))["layers"]
    shapes = effnet.weight_shapes(8)
    for name, expect in shapes.items():
        got = [tree[groups[name]]["vars"][str(i)].array.shape for i in range(len(expect))]
        assert got == [tuple(s) for s in expect], name
    held = {g for g, node in tree.items() if node.get("vars")}
    assert held == {groups[n] for n in shapes}


@pytest.mark.parametrize("batch", (1, 8))
def test_stft_mag_roofline_is_bound_by_operations(batch):
    """The |STFT| kernel's FFT runs in float64 on the CUDA cores: at the
    cells' shapes the operations, not the bytes, set its least time."""
    mag = spec.load_metric("stft_mag_roofline")
    ops, nbytes = mag.work(batch, 2_880_000)
    assert mag.PEAK_FLOPS == 34e12
    assert ops / mag.PEAK_FLOPS > nbytes / mag.HBM_BYTES_PER_S
