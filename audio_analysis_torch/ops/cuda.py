"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface. At first use each one is compiled by
its own ``nvcc`` process, all started together, for ``sm_90a``
(``-gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC``); the
objects are linked into one shared library, loaded with ``ctypes``. The
build lands in ``build/cuda-<hash>/`` next to the package sources, keyed by
a hash of the sources and flags, so an unchanged checkout builds once.

Every C entry point launches on the stream it is given (the wrapper passes
``torch.cuda.current_stream().cuda_stream``), allocates nothing, and
returns ``cudaGetLastError()``; ``check`` raises when that is not 0.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("stft.cu", "stft_bf16.cu", "medians.cu")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libaat_kernels.so"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
# argtypes of every C entry point: c_void_p for pointers and the stream
_SIGNATURES = {
    "aat_smem_optin": [],
    "aat_stft_mel_fft": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I,
                         _F, _I, _P],
    "aat_stft_mag_fft": [_P, _P, _P, _P, _P, _I, _P, _I, _L, _I, _I, _I, _F, _I, _P],
    "aat_stft_mel_fft1": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I,
                          _I, _F, _I, _P],
    "aat_stft_mag_fft1": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _L, _I, _I, _I, _F, _I, _P],
    "aat_stft_mel_bluestein": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                               _L, _I, _I, _I, _I, _I, _F, _I, _P],
    "aat_stft_mag_bluestein": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _L, _I, _I,
                               _I, _F, _I, _P],
    "aat_stft_mag_cluster": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                             _P, _I, _L, _I, _I, _I, _F, _I, _P],
    "aat_stft_mel_cluster": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                             _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _F, _I, _P],
    "aat_stft_cluster_smem": [_I, _I, _I, _I, _I],
    "aat_stft_cluster_occupancy": [_I, _I, _I, _I, _I, _I],
    "aat_stft_mel_bf16": [_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _I, _F, _L,
                          _I, _P],
    "aat_stft_mel_bf16_smem": [_I],
    "aat_stft_mel_dif_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _F, _P],
    "aat_stft_mel_dif_bf16_smem": [_I, _I, _I, _I, _I, _I, _I, _I],
    "aat_row_medians": [_P, _P, _P, _I, _I, _I, _P],
    "aat_col_medians": [_P, _P, _I, _I, _I, _P],
}

_LOCK = threading.Lock()
_LIB = None


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def build_dir() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return BUILD_ROOT / f"cuda-{h.hexdigest()[:16]}"


def _compile(out_dir: Path) -> None:
    """nvcc each source in parallel, link one .so, move it into place
    atomically (concurrent builders each work in their own temp dir)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (name + ".o")
            cmd = [nvcc(), *ARCH_FLAGS, *CFLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        for name, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {name}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        so = tmp / LIB_NAME
        link = [nvcc(), *ARCH_FLAGS, "-shared", *(str(o) for _, o, _ in procs), "-o", str(so)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        (tmp / "build.log").write_text("\n".join(log))
        os.replace(tmp / "build.log", out_dir / "build.log")
        os.replace(so, out_dir / LIB_NAME)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library():
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            d = build_dir()
            if not (d / LIB_NAME).exists():
                _compile(d)
            lib = ctypes.CDLL(str(d / LIB_NAME))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def build_log() -> str:
    """nvcc's output (with ptxas' register and shared-memory report) for the
    current build, once it exists."""
    p = build_dir() / "build.log"
    return p.read_text() if p.exists() else ""


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def smem_optin(device: torch.device) -> int:
    """Shared memory a block of a CUDA device may opt in to, in bytes."""
    with torch.cuda.device(device):
        return library().aat_smem_optin()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def require_cuda(t: torch.Tensor, name: str, dtype=torch.float32) -> None:
    """Wrapper-side validation of what a kernel takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
