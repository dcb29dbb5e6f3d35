"""Native (C++) host ops, compiled on demand and loaded via ctypes.

Copies of the JAX package's host sources and loaders: ``ccl.cpp`` is the
host connected-component labelling that replaces OpenCV's (reference:
src/identify_tracks.py:686); ``pcmcodec.cpp`` is the PCM wire codec's
encoder (``io/pcmcodec.py``). Each is built with one ``g++ -O3
-march=native -shared`` call into ``_<stem>.so`` next to its source, keyed
by a source-hash stamp; without a toolchain the loaders return None and the
callers use their numpy versions.
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
_LIBS = {}
_WRAPPERS = {}


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


def _load_so(stem: str):
    """Build (if stale) and dlopen native/<stem>.cpp -> _<stem>.so; returns
    a ctypes.CDLL or None. Cached per process.

    The .so is never shipped (it is built with -march=native); a source-hash
    stamp next to it decides whether the local build is current."""
    if stem in _LIBS:
        return _LIBS[stem]
    with _LOCK:
        if stem in _LIBS:
            return _LIBS[stem]
        src = _HERE / f"{stem}.cpp"
        so = _HERE / f"_{stem}.so"
        stamp = _HERE / f"_{stem}.so.sha"
        src_hash = hashlib.sha256(src.read_bytes()).hexdigest()
        ok = so.exists() and stamp.exists() and stamp.read_text().strip() == src_hash
        if not ok:
            ok = _build(src, so)
            if ok:
                stamp.write_text(src_hash)
        lib = None
        if ok:
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                logging.warning("could not load native %s library", stem, exc_info=True)
        _LIBS[stem] = lib
        return lib


def _wrapper(stem: str, cls):
    """The one `cls` wrapper of the library `_load_so(stem)` gives, or None.

    Built once per library: a wrapper sets its functions' argtypes, and
    setting them while another thread calls the function (the CCL runs in
    several host threads at once) corrupts that call's conversions."""
    dll = _load_so(stem)
    if dll is None:
        return None
    with _LOCK:
        built = _WRAPPERS.get(stem)
        if built is None or built[0] is not dll:
            built = _WRAPPERS[stem] = (dll, cls(dll))
        return built[1]


class _CclLib:
    """ctypes wrapper for ccl.cpp (the labelling of the packed mask)."""

    def __init__(self, dll):
        words = np.ctypeslib.ndpointer(dtype=np.uint32, ndim=2, flags="C_CONTIGUOUS")
        out2d = np.ctypeslib.ndpointer(dtype=np.int64, ndim=2, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        self.ccl_stats_words = dll.ccl_stats_words
        self.ccl_stats_words.restype = i64
        self.ccl_stats_words.argtypes = [words, i64, i64, i64, out2d]


def load_ccl_library():
    """The compiled CCL library wrapper, or None if unavailable."""
    return _wrapper("ccl", _CclLib)


class _PcmCodecLib:
    """ctypes wrapper for pcmcodec.cpp (the PCM wire codec's host encoder)."""

    def __init__(self, dll):
        pcm = np.ctypeslib.ndpointer(dtype=np.int16, ndim=2, flags="C_CONTIGUOUS")

        def vec(dtype):
            return np.ctypeslib.ndpointer(dtype=dtype, ndim=1, flags="C_CONTIGUOUS")

        i64, i32 = ctypes.c_int64, ctypes.c_int32
        self.widths = dll.pcm_widths
        self.widths.restype = i64
        self.widths.argtypes = [
            pcm, i64, i64, np.ctypeslib.ndpointer(dtype=np.uint8, ndim=2, flags="C_CONTIGUOUS"),
        ]
        self.pack = dll.pcm_pack
        self.pack.restype = i64
        self.pack.argtypes = [pcm, i64, i64, i32, vec(np.uint8), vec(np.int64), vec(np.uint32),
                              vec(np.int32), vec(np.int32), vec(np.uint32)]
        self.pfor = dll.pcm_pfor
        self.pfor.restype = i64
        self.pfor.argtypes = [pcm, i64, i64, i32, vec(np.uint8), vec(np.int32)]


def load_pcmcodec_library():
    """The native PCM wire-codec encoder, or None (numpy fallback)."""
    return _wrapper("pcmcodec", _PcmCodecLib)
