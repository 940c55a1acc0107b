"""Build and load the hand-written Hopper kernels in ../csrc.

All `csrc/*.cu` files compile with nvcc into ONE shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), loaded with
ctypes: one nvcc process per source, all started together, then one link.
The build runs at first use, from the package's own sources, into
`kernels/build/` (git-ignored); the library's file name carries a hash of
the sources and flags, so an edit to any source triggers a rebuild.

Every C entry point launches on the stream it is given and returns
`cudaGetLastError()` after its launches; `check()` raises on a nonzero
code.  Nothing here falls back to the plain torch versions: those are taken
by the wrappers only for CPU tensors.

`LAUNCHES` counts, per kernel, the wrapper calls that launched it (a plain
integer each, bumped by the wrapper right after a successful launch), and
the NTT's int8 GEMMs (torch._int_mm on the card) under "int8_gemm".
`MID_PLANES_BY_PRIME` splits the mid_planes launches by their prime (the
dense tier's three, the pair tier's five).  `COUNTERS` holds the work the
program launched, on every device: "int8_ops", the NTT GEMMs' int8
operations (two a multiply-add, padded rows included, as ops/ntt.py
gemm_ops counts them); "trunc_copy_bytes", the bytes written by the torch
copies of the truncated route (trunc_mfa < conv_len): the concatenations of
ops/truncate.py `_cat` and ops/mfa.py `_cat3`, models/mul.py `_pad_rows`
and the staged pointwise's chunk write-back and fill, each counted where
it copies (`count_copy`).  `reset_launches()` zeroes all three.

`span(name)` marks a stage of the program as "mf.<name>" on a
torch.profiler window's host timeline, on the clock of its device trace;
spans nest by containment.  They are FUNCTION-scope record functions
(`_RecordFunctionFast`), which the profiler does not project onto the
device timeline as it does `record_function`'s, so a window's device
operations stay the kernels alone.  With no profiler recording, a span is
one flag check and a shared no-op context."""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch
from torch.autograd import profiler as _profiler

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_STEM = "libmpir_fft_kernels"

LAUNCHES = {
    "ladder": 0, "ladder_pe": 0, "ladder_pre_half": 0, "mfa_cols": 0, "fused": 0,
    "conv_base": 0,
    "normmod": 0, "normmod_long": 0, "canonicalize": 0,
    "twiddle_half": 0, "sqrt2_top_fwd": 0, "sqrt2_top_inv": 0, "transform_small": 0,
    "transform_small_half": 0,
    "input_planes": 0, "mid_planes": 0, "garner_carry": 0, "garner_carry_post": 0,
    "ntt4_input_planes": 0, "ntt4_fwd_twiddle": 0, "ntt4_pointwise": 0, "ntt4_inv_twiddle": 0,
    "ntt4_residues": 0, "garner_residues": 0, "garner_residues_post": 0, "ntt4_fused": 0,
    "pair_input_planes": 0, "garner_pair_carry": 0,
    "int8_gemm": 0,     # torch._int_mm calls of the NTT (ops/ntt.py _dot_raw), not a csrc kernel
}
MID_PLANES_BY_PRIME: collections.Counter = collections.Counter()
COUNTERS = {"int8_ops": 0, "trunc_copy_bytes": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    MID_PLANES_BY_PRIME.clear()
    for name in COUNTERS:
        COUNTERS[name] = 0


def count_copy(out: torch.Tensor) -> torch.Tensor:
    """out, a tensor a torch copy of the truncated route just wrote, after
    adding its bytes to COUNTERS["trunc_copy_bytes"]."""
    COUNTERS["trunc_copy_bytes"] += out.numel() * out.element_size()
    return out


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records the span "mf.<name>" while a torch.profiler
    records, else the shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast("mf." + name)


def spanned(name: str):
    """Decorator: each call of the function runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


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
    sources exists; return its path.  Each source compiles in its own nvcc
    process, all at once; the objects then link into the library.  The
    seconds each source took and the compilers' resource reports
    (`-Xptxas -v`) are kept beside it as `<lib>.log`."""
    lib = BUILD_DIR / f"{LIB_STEM}_{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]

    def compile_one(src_obj):
        src, obj = src_obj
        t0 = time.perf_counter()
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return res, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        done = list(pool.map(compile_one, zip(srcs, objs)))
    logs = [f"nvcc {src.name}: {secs:.1f} s\n" for src, (_, secs) in zip(srcs, done)]
    logs += [res.stdout for res, _ in done]
    failed = [f"{obj.name} ({res.returncode}):\n{res.stdout}"
              for obj, (res, _) in zip(objs, done) if res.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = lib.with_name(f"{tag}.so.tmp")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    for obj in objs:
        obj.unlink()
    lib.with_suffix(".log").write_text("".join(logs) + res.stdout + res.stderr)
    os.replace(tmp, lib)
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

_SIGNATURES = {
    # x, out, N, K, h, L, inverse, steps (host long long[k]), k,
    # pe (device int32 (N, K/2, 2) or null), pre (pre_half on), pre e0,
    # pre step (half-bit exponents in [0, 4W)), stream
    "mf_ladder": (_P, _P, _LL, _I, _I, _I, _I, _P, _I, _P, _I, _LL, _LL, _P),
    # x, out, schedule (device int64 [nops, 8]), nops, B, n2, L, n1 mask,
    # first column, cross-twiddle w, kmax, R (the column's CTAs), stream
    "mf_mfa_cols": (_P, _P, _P, _I, _LL, _I, _I, _LL, _LL, _LL, _I, _I, _P),
    # a, b, out, B, L, stream
    "mf_conv_base": (_P, _P, _P, _LL, _I, _P),
    # x, out, scratch (mf_normmod_scratch(B, L) ints, or null where that is
    # 0), its ints, B, L, s (shift exponent in [0, 2W), 64-bit), stream
    "mf_normmod": (_P, _P, _P, _LL, _LL, _I, _LL, _P),
    # x, out, scratch (mf_canonicalize_scratch(Bt, N) ints, or null where
    # that is 0), its ints, Bt, N, stream
    "mf_canonicalize": (_P, _P, _P, _LL, _LL, _LL, _P),
    # x, out, B, L, h, e0, step (half-bit exponents), stream
    "mf_twiddle_half": (_P, _P, _LL, _I, _LL, _LL, _LL, _P),
    # x, out, N, h, L, w, stream
    "mf_sqrt2_top_fwd": (_P, _P, _LL, _LL, _I, _LL, _P),
    # x, out, N, h, L, w, s (norm shift in [0, 2W), or -1), stream
    "mf_sqrt2_top_inv": (_P, _P, _LL, _LL, _I, _LL, _I, _P),
    # x, out, B, C, L, w, inverse, kmax, half (pre_half forward / post_half
    # inverse on), its e0, its step (half-bit exponents), R (the CTAs a
    # row), stream
    "mf_transform_small": (_P, _P, _LL, _I, _I, _LL, _I, _I, _I, _LL, _LL, _I, _P),
    # x, out (3 primes' planes), B, M, stream
    "mf_input_planes": (_P, _P, _LL, _I, _P),
    # sa, sb, out, B, M, the prime (a dense or pair tier prime), stream
    "mf_mid_planes": (_P, _P, _P, _LL, _I, _I, _P),
    # x, out (5 primes' planes), B, Mp (pairs a row), stream
    "mf_pair_input_planes": (_P, _P, _LL, _I, _P),
    # s0..s4 (the pair primes' raw inverse sums), out, B, Mp, stream
    "mf_garner_pair_carry": (_P, _P, _P, _P, _P, _P, _LL, _I, _P),
    # s1, s2, s3, out, B, M, post K (0: none), post steps (host long
    # long[k]), k, stream
    "mf_garner_carry": (_P, _P, _P, _P, _LL, _I, _I, _P, _I, _P),
    # r1, r2, r3 (tier-2 residues), out, B, M, post K, post steps, k, stream
    "mf_garner_residues": (_P, _P, _P, _P, _LL, _I, _I, _P, _I, _P),
    # x, out (3 primes' planes), B, M, stream
    "mf_ntt4_input_planes": (_P, _P, _LL, _I, _P),
    # S, table, out, B, R, C, prime index, inverse, stream
    "mf_ntt4_twiddle": (_P, _P, _P, _LL, _I, _I, _I, _I, _P),
    # sa, sb, out, rows, C, prime index, stream
    "mf_ntt4_pointwise": (_P, _P, _P, _LL, _I, _I, _P),
    # S, out, B, M, prime index, stream
    "mf_ntt4_residues": (_P, _P, _LL, _I, _I, _P),
    # a, b, tables, out (3 primes' residues), B, M, stream
    "mf_ntt4_fused": (_P, _P, _P, _P, _LL, _I, _P),
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
    for fn in (so.mf_canonicalize_tile, so.mf_canonicalize_row_max, so.mf_normmod_short_max,
               so.mf_normmod_row_max, so.mf_normmod_long_max, so.mf_conv_base_short_max):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    so.mf_canonicalize_scratch.argtypes = [_LL, _LL]
    so.mf_canonicalize_scratch.restype = ctypes.c_longlong
    so.mf_normmod_scratch.argtypes = [_LL, _I]
    so.mf_normmod_scratch.restype = ctypes.c_longlong
    return so


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = lib().mf_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cuda error {rc})")


def stream_of(t: torch.Tensor) -> int:
    """Raw cudaStream_t of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream
