"""Native (C++) host ops, compiled on demand and loaded via ctypes.

Copy of the JAX package's CCL loader: ``ccl.cpp`` is the host
connected-component labelling that replaces OpenCV's
(reference: src/identify_tracks.py:686). It is built with one
``g++ -O3 -shared`` call into ``_ccl.so`` next to this file, keyed by a
source-hash stamp; without a toolchain the callers use the numpy version.
"""

import ctypes
import hashlib
import logging
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_LOCK = threading.Lock()
_CCL_LIB = None
_CCL_TRIED = False


def _build(src: Path, out: Path) -> bool:
    # build to a temporary name and rename, so a concurrent loader never
    # opens a half-written library
    tmp = out.with_name(out.name + ".tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        tmp.replace(out)
        return True
    except (OSError, subprocess.SubprocessError):
        logging.warning("native build failed for %s; using numpy fallback", src.name, exc_info=True)
        return False


class _CclLib:
    def __init__(self, dll):
        mask2d = np.ctypeslib.ndpointer(dtype=np.uint8, ndim=2, flags="C_CONTIGUOUS")
        out2d = np.ctypeslib.ndpointer(dtype=np.int64, ndim=2, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        self._fn = dll.ccl_stats
        self._fn.restype = i64
        self._fn.argtypes = [mask2d, i64, i64, out2d]
        self._fn_packed = dll.ccl_stats_packed
        self._fn_packed.restype = i64
        self._fn_packed.argtypes = [mask2d, i64, i64, i64, out2d]
        self._fn_runs = dll.ccl_stats_runs
        self._fn_runs.restype = i64
        runs = np.ctypeslib.ndpointer(dtype=np.int32, ndim=1, flags="C_CONTIGUOUS")
        self._fn_runs.argtypes = [runs, runs, i64, i64, i64, out2d]

    def ccl_stats(self, mask, h, w, out):
        return self._fn(mask, h, w, out)

    def ccl_stats_packed(self, packed, h, w, w_bytes, out):
        return self._fn_packed(packed, h, w, w_bytes, out)

    def ccl_stats_runs(self, starts, ends, n_runs, h, w, out):
        return self._fn_runs(starts, ends, n_runs, h, w, out)


def load_ccl_library():
    """Return the compiled CCL library wrapper, or None if unavailable.

    The .so is never shipped (it is built with -march=native); a source-hash
    stamp next to it decides whether the local build is current."""
    global _CCL_LIB, _CCL_TRIED
    if _CCL_TRIED:
        return _CCL_LIB
    with _LOCK:
        if _CCL_TRIED:
            return _CCL_LIB
        src = _HERE / "ccl.cpp"
        so = _HERE / "_ccl.so"
        stamp = _HERE / "_ccl.so.sha"
        src_hash = hashlib.sha256(src.read_bytes()).hexdigest()
        ok = so.exists() and stamp.exists() and stamp.read_text().strip() == src_hash
        if not ok:
            ok = _build(src, so)
            if ok:
                stamp.write_text(src_hash)
        if ok:
            try:
                _CCL_LIB = _CclLib(ctypes.CDLL(str(so)))
            except OSError:
                logging.warning("could not load native CCL library", exc_info=True)
        _CCL_TRIED = True
        return _CCL_LIB
