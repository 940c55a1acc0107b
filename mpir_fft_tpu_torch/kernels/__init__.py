"""Build and load the hand-written Hopper kernels in ../csrc.

All `csrc/*.cu` files compile with nvcc into ONE shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), loaded with
ctypes.  The build runs at first use, from the package's own sources, into
`kernels/build/` (git-ignored); the library's file name carries a hash of
the sources and flags, so an edit to any source triggers a rebuild.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()` after its launches; `check()` raises on a nonzero
code.  Nothing here falls back to the plain torch versions: those are taken
by the wrappers only for CPU tensors.

`LAUNCHES` counts, per kernel, the wrapper calls that launched it (a plain
integer each, bumped by the wrapper right after a successful launch)."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_STEM = "libmpir_fft_kernels"

LAUNCHES = {"ladder": 0, "conv_base": 0, "normmod": 0, "canonicalize": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the kernels build only where the CUDA toolkit is")


def build() -> pathlib.Path:
    """Compile csrc/*.cu for sm_90a unless a library for the current
    sources exists; return its path.  The compiler's resource report
    (`-Xptxas -v`) is kept beside it as `<lib>.log`."""
    lib = BUILD_DIR / f"{LIB_STEM}_{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cus = [str(s) for s in _sources() if s.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *cus]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    lib.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, lib)
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

_SIGNATURES = {
    # x, out, N, K, h, L, inverse, steps (host long long[k]), k, stream
    "mf_ladder": (_P, _P, _LL, _I, _I, _I, _I, _P, _I, _P),
    # a, b, out, B, L, stream
    "mf_conv_base": (_P, _P, _P, _LL, _I, _P),
    # x, out, B, L, s (shift exponent in [0, 2W)), stream
    "mf_normmod": (_P, _P, _LL, _I, _I, _P),
    # x, out, y, t, g, p, rc, Bt, N, R, stream
    "mf_canonicalize": (_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _P),
}


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    so = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    so.mf_error_string.argtypes = [ctypes.c_int]
    so.mf_error_string.restype = ctypes.c_char_p
    so.mf_canonicalize_tile.argtypes = []
    so.mf_canonicalize_tile.restype = ctypes.c_int
    return so


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = lib().mf_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cuda error {rc})")


def stream_of(t: torch.Tensor) -> int:
    """Raw cudaStream_t of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream
