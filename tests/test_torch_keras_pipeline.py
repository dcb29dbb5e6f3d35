"""Keras classifiers through the port's entry points, against the JAX
package on the CPU: the registry's compute-dtype precedence and model cache,
the analyse CLI with an EfficientNet-named Keras model over [160, 226, 3],
two model groups (the 3-channel repeat follows the current group's model),
batch serving under AAT_FAST=1 (a bfloat16 Keras model), and AAT_TIMINGS's
accepted words in both packages."""

import contextlib
import io
import json
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import keras  # noqa: E402
from keras import layers as kl  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (fixtures and the result contract)

SR = 48000
LABELS = ["bird", "kiwi", "morepork", "noise"]


def _keras_effnet(model_dir, seed=0, **meta):
    """An EfficientNet-named Keras model over [160, 226, 3] mel windows (an
    MBConv block: stem, depthwise, squeeze-excite, projection; then a
    flattened head, where the NHWC order matters) with bench.py's frontend;
    its metadata updated with `meta`. BatchNormalization's moving
    statistics are those of chip_smoke's calibration windows (one
    training-mode call with momentum 0), so the probabilities follow the
    input."""
    keras.utils.set_random_seed(seed)
    bn = partial(kl.BatchNormalization, momentum=0.0)
    inp = keras.Input((160, 226, 3))
    x = kl.Rescaling(1.0 / 255.0)(inp)
    x = kl.Conv2D(8, 3, strides=2, padding="same", use_bias=False)(x)
    x = kl.Activation("swish")(bn()(x))
    x = kl.DepthwiseConv2D(3, strides=2, padding="same", use_bias=False)(x)
    x = kl.Activation("swish")(bn()(x))
    se = kl.GlobalAveragePooling2D(keepdims=True)(x)
    se = kl.Conv2D(8, 1, activation="sigmoid")(kl.Conv2D(2, 1, activation="swish")(se))
    x = kl.Multiply()([x, se])
    x = bn()(kl.Conv2D(16, 1, use_bias=False)(x))
    x = kl.Flatten()(kl.MaxPooling2D(4)(x))
    model = keras.Model(inp, kl.Dense(len(LABELS), activation="softmax")(x))
    model(chip_smoke.calibration_grid(seed).numpy(), training=True)
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    model.save(str(model_dir / "audioModel.keras"))
    base = {
        "name": "efficientnet-small", "labels": LABELS, "segment_length": 3,
        "segment_stride": 1.5, "hop_length": 640, "n_mels": 160, "break_freq": 1750,
        "htk": True, "fmin": 50, "fmax": 11000, "power": 2, "db_scale": True,
        "threshold": 0.5, "n_fft": 4096, "normalize": True,
    }
    (model_dir / "metadata.txt").write_text(json.dumps({**base, **meta}))
    return str(model_dir)


@pytest.fixture(scope="module")
def effnet(tmp_path_factory):
    return _keras_effnet(tmp_path_factory.mktemp("effnet") / "m")


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    from audio_analysis_torch.io.audio import write_wav

    p = tmp_path_factory.mktemp("wav") / "rec.wav"
    write_wav(p, chip_smoke.make_recording(seconds=16, silent_from=13.0, seed=3), SR)
    return p


def _cli_json(run, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run(argv)
    res = json.loads(buf.getvalue())
    res.pop("processing_time_seconds")
    return res


def _labels(res):
    return [p["label"] for t in res["species_identify"] for r in t.get("model_results", [])
            for p in r["predictions"]]


@pytest.mark.parametrize("net_dtype", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("keras_bf16", [None, "1", "0", "yes"])
@pytest.mark.parametrize("fast", [None, "1", "0"])
def test_compute_dtype_precedence_matches_jax(monkeypatch, net_dtype, keras_bf16, fast):
    """metadata net_dtype, then AAT_KERAS_BF16, then the AAT_FAST preset."""
    from audio_analysis_tpu.io.modelconfig import ModelConfig as JCfg
    from audio_analysis_tpu.models.registry import _resolved_compute_dtype as j_dtype

    from audio_analysis_torch.io.modelconfig import ModelConfig
    from audio_analysis_torch.models.registry import _resolved_compute_dtype

    for name, v in (("AAT_KERAS_BF16", keras_bf16), ("AAT_FAST", fast)):
        if v is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, v)
    raw = {"labels": LABELS} | ({"net_dtype": net_dtype} if net_dtype else {})
    assert _resolved_compute_dtype(ModelConfig(raw=raw)) == j_dtype(JCfg(raw=raw))


def test_model_cache_keys_on_the_compute_dtype(effnet, monkeypatch):
    from audio_analysis_torch.io.modelconfig import ModelConfig
    from audio_analysis_torch.models import KerasModel
    from audio_analysis_torch.models.registry import load_classifier

    cfg = ModelConfig.load(Path(effnet))
    monkeypatch.delenv("AAT_FAST", raising=False)
    monkeypatch.delenv("AAT_KERAS_BF16", raising=False)
    f32 = load_classifier(effnet, cfg, "cpu")
    monkeypatch.setenv("AAT_FAST", "1")
    bf16 = load_classifier(effnet, cfg, "cpu")
    assert isinstance(bf16, KerasModel) and bf16 is not f32
    assert (f32.compute_dtype, bf16.compute_dtype) == (None, torch.bfloat16)
    monkeypatch.delenv("AAT_FAST")
    monkeypatch.setenv("AAT_KERAS_BF16", "1")  # resolves to the same dtype: one instance
    assert load_classifier(effnet, cfg, "cpu") is bf16
    monkeypatch.setenv("AAT_KERAS_BF16", "0")
    assert load_classifier(effnet, cfg, "cpu") is f32


def test_cli_json_with_efficientnet_keras_model_equals_jax(effnet, wav, monkeypatch):
    """The analyse CLI's JSON, apart from processing_time_seconds, with the
    channel repeat applied to the Keras model's [160, 226, 3] input."""
    from audio_analysis_torch.cli.analyse import run as torch_run
    from audio_analysis_tpu.cli.analyse import run as jax_run

    for knob in ("AAT_FAST", "AAT_PALLAS", "AAT_KERAS_BF16"):
        monkeypatch.delenv(knob, raising=False)
    argv = ["-o", str(wav), "--bird-model", effnet, "--seed", "0"]
    ref = _cli_json(jax_run, argv)
    got = _cli_json(torch_run, argv + ["--device", "cpu"])
    assert ref["species_identify"] and _labels(ref), "the fixture must produce labels"
    chip_smoke.compare_results(got, ref)
    assert got == ref


@pytest.mark.parametrize("order", ["tuinet-then-keras", "keras-then-tuinet"])
def test_channel_repeat_follows_the_current_group(tmp_path, effnet, order):
    """Two model groups (the second a pre-model): only the EfficientNet
    group's input is repeated to 3 channels, whichever group comes first
    (reference src/identify_tracks.py:539-540); the other group's TuiNet
    takes the 1-channel features. Equal to the JAX classify."""
    from audio_analysis_tpu.pipeline.classify import classify_frames as j_classify
    from audio_analysis_torch.pipeline.classify import classify_frames

    from test_torch_fast import _result

    pre = order == "tuinet-then-keras"
    tuinet = chip_smoke.write_tuinet_model(tmp_path / "tuinet", seed=1, channels=(8, 16),
                                           stem=8, dense=16, n_mels=160, labels=LABELS,
                                           threshold=0.3, pre_model=not pre, name="tui")
    keras_dir = _keras_effnet(tmp_path / "keras", seed=2, pre_model=pre)
    models = [str(tuinet), keras_dir]
    y = chip_smoke.make_recording(seconds=12, silent_from=10.0, seed=3)
    ref = _result(*j_classify(y, SR, models, False, None, rng=np.random.RandomState(0)))
    got = _result(*classify_frames(y, SR, models, False, None, rng=np.random.RandomState(0),
                                   device="cpu"))
    names = {r["model"] for t in ref["species_identify"] for r in t.get("model_results", [])}
    assert names == {"tui", "efficientnet-small"}, "both groups must run"
    chip_smoke.compare_results(got, ref)
    assert got == ref


def test_fast_batch_with_keras_model_matches_jax(tmp_path, monkeypatch):
    """BatchAnalyzer under AAT_FAST=1 (the Keras model in bfloat16 by the
    preset, the bf16 frontend's dif route) against the JAX package's fast
    batch (its Pallas frontend forced on the CPU backend, in interpret
    mode, as tests/test_torch_fast.py runs it): signals, lengths and labels
    identical, confidences within 5. Not tests/test_torch_fast.py's 1: XLA
    fuses the batch norms and activations into each convolution in float32
    and rounds to bfloat16 once, eager PyTorch rounds after every op, so the
    port's bfloat16 probabilities move further from float32 (on these
    recordings with the model's seed 0: up to 4 points, the JAX package's 1;
    with that model in float32 at the same level the two packages'
    confidences are equal)."""
    import audio_analysis_tpu.pipeline.frontend as jfe
    from audio_analysis_tpu.ops.pallas import medians as jmd
    from audio_analysis_tpu.ops.pallas import melspec as jm
    from audio_analysis_tpu.pipeline.serve import BatchAnalyzer as JBatch
    from audio_analysis_torch.pipeline.serve import BatchAnalyzer

    monkeypatch.setattr(jfe, "_pallas_backend", lambda: True)
    monkeypatch.setenv("AAT_FAST", "1")
    for knob in ("AAT_PALLAS", "AAT_PALLAS_ALG", "AAT_KERAS_BF16"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setattr(jm, "pallas_mel_spectrogram",
                        partial(jm.pallas_mel_spectrogram, interpret=True))
    monkeypatch.setattr(jm, "pallas_stft_magnitude",
                        partial(jm.pallas_stft_magnitude, interpret=True))
    monkeypatch.setattr(jmd, "pallas_masked_medians_rowcol",
                        partial(jmd.pallas_masked_medians_rowcol, interpret=True))
    effnet = _keras_effnet(tmp_path / "m", seed=2, threshold=0.3)
    recs = [chip_smoke.make_recording(seconds=9, silent_from=8.0, seed=3),
            chip_smoke.make_recording(seconds=8.5, silent_from=8.5, seed=5)]
    ref = JBatch([effnet], sr=SR, bucket_seconds=9, rng=None).analyse_recordings(recs)
    analyzer = BatchAnalyzer([effnet], sr=SR, bucket_seconds=9, rng=None, device="cpu")
    assert analyzer.groups[0][0][0].compute_dtype == torch.bfloat16
    got = analyzer.analyse_recordings(recs)
    assert sum(len(_labels(r)) for r in ref) >= 2, "the fixture must produce labels"
    for g, r in zip(got, ref):
        g, r = json.loads(json.dumps(g)), json.loads(json.dumps(r))
        chip_smoke.compare_results(g, r, confidence_tol=5)


@pytest.mark.parametrize("word,timed", [("yes", False), ("on", True), ("1", True),
                                        ("TRUE", True), ("0", False)])
def test_timings_words_match_jax(effnet, wav, tmp_path, monkeypatch, word, timed):
    """AAT_TIMINGS: both packages take only 1/true/on, for analyse and for
    analyse_recordings; `timing` carries the same stage names."""
    from audio_analysis_torch.pipeline.analysis import species_identify
    from audio_analysis_torch.pipeline.serve import BatchAnalyzer
    from audio_analysis_tpu.pipeline.analysis import species_identify as j_species_identify
    from audio_analysis_tpu.pipeline.serve import BatchAnalyzer as JBatch

    model = str(chip_smoke.write_tuinet_model(tmp_path / "m", seed=1, channels=(8,), stem=8,
                                              dense=8, n_mels=40))
    monkeypatch.setenv("AAT_TIMINGS", word)
    for knob in ("AAT_FAST", "AAT_PALLAS"):
        monkeypatch.delenv(knob, raising=False)
    single = (species_identify(str(wav), [model], False, rng=None, device="cpu"),
              j_species_identify(str(wav), [model], False, rng=None))
    rec = [chip_smoke.make_recording(seconds=6, silent_from=6.0, seed=4)]
    batch = (BatchAnalyzer([model], sr=SR, bucket_seconds=6, rng=None,
                           device="cpu").analyse_recordings(rec)[0],
             JBatch([model], sr=SR, bucket_seconds=6, rng=None).analyse_recordings(rec)[0])
    for got, ref in (single, batch):
        assert ("timing" in got) == ("timing" in ref) == timed
        if timed:
            assert sorted(got["timing"]) == sorted(ref["timing"])
