"""The work a result implies, counted as the kernels and the layer shapes
count it, whatever code later does it: the FLOPs of detection (the |STFT|
and the end-scan mel), of the classify frontend (DFT and mel over every
window the result's tracks imply, no padding window) and of each CNN
(2 x the MACs from its layer shapes). A kernel's roofline keeps its own
operations, bytes and peaks in its metric's file.
"""

from types import SimpleNamespace

import numpy as np

from benchref import dsp
from benchref.mel import filterbank_np, mel_support_bins
from benchref.samples import plan_windows

SR = 48000


def mel_nonzeros(n_fft, n_mels, fmin, fmax, break_freq, htk=True):
    bu = mel_support_bins(SR, n_mels, fmin, fmax, n_fft, break_freq, htk)
    return int(np.count_nonzero(filterbank_np(SR, n_mels, fmin, fmax, n_fft, break_freq, htk)[:, :bu]))


def mag_frames(samples):
    return dsp.n_frames(samples, dsp.N_FFT, dsp.HOP)


def endscan_frames(samples):
    chunk = SR // dsp.HOP
    return ((1 + samples // dsp.HOP) // chunk) * chunk


def detection_flops(samples):
    """The |STFT| (n_fft 4096) and the end-scan mel (n_fft 4800, 120 mels,
    power 1) of one recording of `samples`."""
    endscan = dsp.fft_flops(SR // 10) + 2 * mel_nonzeros(SR // 10, dsp.ENDSCAN_MELS, 50.0,
                                                        11000.0, 1750.0)
    return mag_frames(samples) * dsp.fft_flops(dsp.N_FFT) + endscan_frames(samples) * endscan


def cnn_macs(config):
    """MACs of one window through each of the configuration's models, by
    its architecture's own counter."""
    from benchlib.spec import load_architecture

    arch = load_architecture(config["architecture"])
    return [arch.macs(config, spec) for spec in config["models"]]


def window_flops(config):
    """Frontend plus every model, for one classify window."""
    m = config["models"][0]["metadata"]
    n_fft, hop = int(m["n_fft"]), int(m["hop_length"])
    frames = 1 + int(m["segment_length"] * SR) // hop
    frontend = frames * (dsp.fft_flops(n_fft) + 2 * mel_nonzeros(
        n_fft, int(m["n_mels"]), float(m["fmin"]), float(m["fmax"]), float(m["break_freq"])))
    return frontend + 2 * sum(cnn_macs(config))


def windows_of(result, samples, config):
    """Windows the result's tracks imply (the first model's plan)."""
    m = config["models"][0]["metadata"]
    tracks = [SimpleNamespace(start=t["begin_s"], end=t["end_s"], freq_start=t["freq_start"],
                              freq_end=t["freq_end"]) for t in result["species_identify"]]
    if not tracks:
        return 0
    plan = plan_windows(samples, SR, tracks, m["segment_length"], m["segment_stride"],
                        fmin=m["fmin"], fmax=m["fmax"], rng=None)
    return len(plan.base)


def result_flops(result, samples, config):
    return detection_flops(samples) + windows_of(result, samples, config) * window_flops(config)
