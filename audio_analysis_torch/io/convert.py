"""TF SavedModel -> ``.keras`` conversion (the JAX package's io/convert.py).

The reference's legacy morepork ensembles are TF1/TF2-Keras SavedModel dirs
loaded per member with ``tf.keras.models.load_model(saved_model_dir)``
(reference: src/identify_morepork.py:30-39, 169-176). The port runs models
TF-free (models/keras_graph.py), so a SavedModel is converted once:

1. load with the legacy Keras runtime (``tf_keras``; Keras 3 dropped
   SavedModel loading);
2. re-save as a ``.keras`` v3 archive;
3. validate by loading it with the port's ``KerasModel`` on the CPU and
   checking logit parity on random input.

``auto_convert_saved_model`` caches the conversion in ``<src>/.aat_native``
(or under ``~/.cache`` when the dir is read-only), stamped with
``saved_model.pb``'s st_mtime_ns, the JAX package's cache, so either
package reuses the other's conversion; a current cache returns without
importing tensorflow, which a machine without it therefore never needs.

Non-Keras SavedModels (plain ``tf.saved_model.save`` exports) have no layer
graph to rebuild; ``HostSavedModel`` runs them through TF on the host, the
reference's own execution model. tensorflow and tf_keras are imported only
inside the functions that need them.
"""

import hashlib
import json
import logging
import os
import shutil
from pathlib import Path

import numpy as np
import torch

ARCHIVE = "audioModel.keras"


class ConversionError(RuntimeError):
    pass


def _input_shape_of(model):
    shape = model.inputs[0].shape.as_list() if model.inputs else None
    if shape is None:
        raise ConversionError("model has no defined input signature")
    return [1 if d is None else int(d) for d in shape]


def convert_saved_model(src, dst, labels=None, parity_atol=1e-4):
    """Convert a Keras SavedModel dir at `src` into `dst/audioModel.keras`
    (+ metadata.txt if none exists), validating logit parity between the TF
    model and the port's TF-free import. Returns `dst`."""
    src, dst = Path(src), Path(dst)
    try:
        import tf_keras
    except ImportError as e:
        raise ConversionError("converting a SavedModel requires tensorflow + tf_keras") from e

    try:
        model = tf_keras.models.load_model(str(src), compile=False)
    except Exception as e:  # tf_keras raises many types for a non-Keras dir
        raise ConversionError(f"{src} is not a Keras SavedModel (no Keras metadata): {e}") from e
    if not isinstance(model, tf_keras.Model):
        # tf_keras silently returns a _UserObject for plain
        # tf.saved_model.save exports: no layer graph to reconstruct
        raise ConversionError(
            f"{src} is a plain tf.saved_model export (no Keras layer graph); "
            "run it via HostSavedModel instead"
        )

    dst.mkdir(parents=True, exist_ok=True)
    out = dst / ARCHIVE
    model.save(str(out), save_format="keras_v3")

    # validate: the port's TF-free import must reproduce the TF logits
    from audio_analysis_torch.models.keras_graph import KerasModel

    km = KerasModel.load(out)
    shape = _input_shape_of(model)
    shape[0] = 2
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(model(x))
    with torch.inference_mode():
        got = km(torch.from_numpy(x)).numpy()
    if not np.allclose(got, want, atol=parity_atol):
        raise ConversionError(
            f"converted model diverges from TF: max abs err "
            f"{float(np.abs(got - want).max()):.2e} > {parity_atol}"
        )

    meta_src = src / "metadata.txt"
    if meta_src.exists():
        shutil.copy(meta_src, dst / "metadata.txt")
    elif not (dst / "metadata.txt").exists():
        (dst / "metadata.txt").write_text(
            json.dumps({"name": src.name, "labels": labels or ["morepork"]}, indent=4)
        )
    return dst


def _cache_dir_for(src: Path) -> Path:
    """Conversion cache location: inside the model dir when writable,
    otherwise under ~/.cache keyed by path+mtime."""
    src = Path(src)
    if os.access(src, os.W_OK):
        return src / ".aat_native"
    key = hashlib.sha1(f"{src.resolve()}:{src.stat().st_mtime_ns}".encode()).hexdigest()[:16]
    return Path.home() / ".cache" / "audio_analysis_tpu" / "converted" / key


def auto_convert_saved_model(src):
    """Convert-and-cache: returns the converted model dir for a SavedModel,
    reusing a previous conversion when the SavedModel is unchanged."""
    src = Path(src)
    pb = src / "saved_model.pb"
    if not pb.exists():
        raise ConversionError(f"{src} has no saved_model.pb")
    cache = _cache_dir_for(src)
    stamp_file = cache / ".stamp"
    stamp = str(pb.stat().st_mtime_ns)
    if stamp_file.exists() and stamp_file.read_text() == stamp and (cache / ARCHIVE).exists():
        return cache
    logging.info("converting SavedModel %s -> %s", src, cache)
    convert_saved_model(src, cache)
    stamp_file.write_text(stamp)
    return cache


class HostSavedModel:
    """Opaque host-TF execution of a non-Keras SavedModel, the reference's
    own execution model. Takes a torch tensor and returns torch tensors on
    its device; TF runs on numpy copies on the host."""

    def __init__(self, path):
        import tensorflow as tf

        self._tf = tf
        loaded = tf.saved_model.load(str(path))
        fn = None
        if getattr(loaded, "signatures", None):
            fn = loaded.signatures.get("serving_default")
            if fn is None and loaded.signatures:
                fn = next(iter(loaded.signatures.values()))
        self._loaded = loaded  # keep alive
        self._fn = fn if fn is not None else loaded

    def __call__(self, x):
        device = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

        def back(a):
            return torch.tensor(np.asarray(a), device=device)

        out = self._fn(self._tf.constant(x))
        if isinstance(out, dict):
            if len(out) == 1:
                out = next(iter(out.values()))
            elif len(out) == 2:
                # the (logits, embedding) embedder contract (reference
                # src/identify_tracks.py:363, model.infer_tf): accept only
                # when exactly ONE key names the embedding; guessing by key
                # order could silently swap the pair
                keys = sorted(out)
                emb_keys = [k for k in keys if "embed" in k.lower()]
                if len(emb_keys) != 1:
                    raise ValueError(
                        f"ambiguous SavedModel outputs: {keys} (need exactly "
                        "one key containing 'embed' to identify the embedding)"
                    )
                emb = emb_keys[0]
                logits = next(k for k in keys if k != emb)
                return back(out[logits]), back(out[emb])
            else:
                raise ValueError(f"ambiguous SavedModel outputs: {sorted(out)}")
        if isinstance(out, (list, tuple)):
            return tuple(back(o) for o in out)
        return back(out)
