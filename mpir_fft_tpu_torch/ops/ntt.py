"""Pointwise multiplication mod p = 2^(16M)+1 by a negacyclic NTT over
three small primes with CRT recombination (counterpart of
mpir_fft_tpu/ops/ntt.py: its dense tier and its 4-step tier).

Per prime p, c mod p = INTT_p(NTT_p(a) * NTT_p(b)), each transform int8
matrix products with int32 sums: a value mod p enters as k signed-int8
planes (v = v0 + 256 v1 (+ 65536 v2), balanced), and the 256^j factors of
the high planes sit in the matrix (row-plane j of a block holds the planes
of 256^j V mod p), so the raw sums S = [S0 | .. | S_(k-1)] fold high to low
to the value mod p.

Dense tier, M <= 2048 (TIER1_MAX_M): primes PRIMES (P ~ 2^44.8), k = 2,
each transform ONE [B, 2M] @ [2M, 2M] product.  After one balanced carry
pass the digits are below 2^15 + 2^9 + 2, so the negacyclic coefficients
stay below M (2^15 + 2^9 + 2)^2 < 2^41.1 < P/2.

4-step tier, M = 4096 and 8192: primes PRIMES_T2 (P ~ 2^50.1; |c| <
2^43.1 < P/2), k = 3, M = m1 m2 (m1 = 2^(lg M // 2)) and each transform two
passes of m-point plane-block products with a twiddle between them
(_ntt4_mats; the negacyclic psi weights ride F1/T and Ti/G1).  The rows of
every GEMM are B*m long and contracted last, so each one is a single 2-D
torch._int_mm; the transposes of the 4-step happen inside the link kernels.
The batch runs in row chunks that keep the largest int32 GEMM output under
NTT4_CHUNK_BYTES.

Garner's mixed radix gives the signed coefficient c exactly in int64; its
three base-2^16 pieces land at digits i, i+1, i+2 (negacyclic) and one
carry pass bounds the result below 2^16 + 2^12.  Under the garner_post
hook (the staged flagship's), both Garner kernels also run the innermost
inverse ladder group on each block of K rows before writing them.

The host part (primes, roots, plane-block matrices, 4-step tables, Garner
constants) is a copy of the reference's.  The device part is plain torch on
int32 / int64 tensors with exact integer reduction (the reference's
f32-Barrett reductions are a TPU workaround for slow integer division); the
links between the GEMMs run as hand-written kernels -- csrc/ntt_links.cu
(input_planes, mid_planes, garner_carry, garner_residues) and csrc/ntt4.cu
(ntt4_input_planes, ntt4_fwd_twiddle, ntt4_pointwise, ntt4_inv_twiddle,
ntt4_residues, and ntt4_fused, the whole 4-step pipeline per row under
MPIR_FFT_NTT_FUSED=1) -- wrapped here beside their plain versions.  The
GEMMs themselves are torch._int_mm (the reference leaves them to XLA,
outside any kernel)."""

from __future__ import annotations

import collections
import contextlib
import contextvars
import ctypes
import functools
import os

import numpy as np
import torch

from .. import kernels
from .fused import _require, _steps_arg, ladder_fits
from .limb import DIGIT_BITS, _wrap_inject, carry_pass, normmod
from .transforms import ifft_innermost_body

PRIMES = (12289, 40961, 61441)       # P ~ 2^44.8; |c| < P/2 up to M = 2048
PRIMES_T2 = (65537, 114689, 163841)  # P ~ 2^50.1; |c| < P/2 up to M = 8192
TIER1_MAX_M = 2048
NTT_MAX_M = 8192


def _tier(M: int) -> tuple[tuple[int, int, int], int]:
    """(primes, planes) serving transform length M."""
    if M <= TIER1_MAX_M:
        return PRIMES, 2
    return PRIMES_T2, 3


def ntt_supported(M: int) -> bool:
    return 4 <= M <= NTT_MAX_M and (M & (M - 1)) == 0


# ---------------------------------------------------------------------------
# Host: roots and plane-block transform matrices (copied from the reference)
# ---------------------------------------------------------------------------

def _factorize(n: int) -> list[int]:
    fs, d = [], 2
    while d * d <= n:
        if n % d == 0:
            fs.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


def _generator(p: int) -> int:
    fs = _factorize(p - 1)
    for g in range(2, p):
        if all(pow(g, (p - 1) // q, p) != 1 for q in fs):
            return g
    raise AssertionError(f"no generator mod {p}")


@functools.lru_cache(maxsize=None)
def _psi(p: int, M: int) -> int:
    """Primitive 2M-th root mod p with psi^M == -1."""
    assert (p - 1) % (2 * M) == 0, (p, M)
    psi = pow(_generator(p), (p - 1) // (2 * M), p)
    assert pow(psi, M, p) == p - 1
    return psi


def _center(v: np.ndarray, p: int) -> np.ndarray:
    return np.where(v > p // 2, v - p, v).astype(np.int64)


def _split_planes(v: np.ndarray, k: int) -> list[np.ndarray]:
    """Signed value -> k planes with v = sum_j planes[j] * 256^j, the low
    k-1 balanced into [-128, 128)."""
    planes = []
    for _ in range(k - 1):
        lo = ((v + 128) % 256) - 128
        planes.append(lo)
        v = (v - lo) >> 8
    planes.append(v)
    return planes


def _plane_block(V: np.ndarray, p: int, k: int) -> np.ndarray:
    """[M, M] value matrix mod p -> [kM, kM] signed-int8 plane block so that
    for X = [x0 | .. | x_{k-1}] (input planes), X @ block = [S0 | .. | S_{k-1}]
    with  x @ V mod p == sum_j 256^j * S_j  (mod p)."""
    rows = []
    for j in range(k):
        Uj = (V * (256**j)) % p
        rows.append(np.concatenate(_split_planes(_center(Uj, p), k), axis=1))
    blk = np.concatenate(rows, axis=0)
    assert blk.min() >= -128 and blk.max() <= 127
    return blk.astype(np.int8)


def _matrices(M: int) -> list[dict]:
    primes, planes = _tier(M)
    return _matrices_p(M, primes, planes)


@functools.lru_cache(maxsize=None)
def _matrices_p(M: int, primes: tuple, planes: int) -> list[dict]:
    """Per prime: plane-block forward/inverse negacyclic NTT matrices.
    F[i, k] = psi^(i(2k+1)); G[k, j] = M^-1 psi^(-j(2k+1))  (mod p)."""
    out = []
    for p in primes:
        psi = _psi(p, M)
        pows = np.empty(2 * M, np.int64)
        acc = 1
        for e in range(2 * M):
            pows[e] = acc
            acc = acc * psi % p
        i = np.arange(M, dtype=np.int64)[:, None]
        k = np.arange(M, dtype=np.int64)[None, :]
        F = pows[(i * (2 * k + 1)) % (2 * M)]
        Minv = pow(M, -1, p)
        G = (Minv * pows[(-(k * (2 * i + 1))) % (2 * M)]) % p
        out.append({"p": p, "k": planes,
                    "F": _plane_block(F, p, planes),
                    "G": _plane_block(G, p, planes)})
    return out


@functools.lru_cache(maxsize=None)
def _ntt4_mats(M: int) -> list[dict]:
    """Per prime: 4-step (Bailey) factorization of the length-M cyclic DFT
    into two length-m DFT matmul passes with an elementwise twiddle between
    them.  The negacyclic psi^i weights are folded into the matrices:
    psi^(i1*m2+i2) = psi^(i1*m2) psi^(i2) -- the i1 part scales F1's rows,
    the i2 part rides the cross-twiddle table T (and on the inverse side
    psi^(-i2) rides Ti, M^-1 psi^(-i1*m2) scales G1's columns).  The forward
    transform emits the spectrum in (k1, k2)-blocked permuted order, which
    the inverse consumes as it is."""
    primes, k = _tier(M)
    lg = M.bit_length() - 1
    m1 = 1 << (lg // 2)
    m2 = M // m1
    out = []
    for p in primes:
        psi = _psi(p, M)
        om = psi * psi % p                      # primitive M-th root
        pw = np.empty(M, np.int64)
        acc = 1
        for e in range(M):
            pw[e] = acc
            acc = acc * om % p
        ppw = np.empty(2 * M, np.int64)
        acc = 1
        for e in range(2 * M):
            ppw[e] = acc
            acc = acc * psi % p
        i1 = np.arange(m1, dtype=np.int64)
        i2 = np.arange(m2, dtype=np.int64)
        Minv = pow(M, -1, p)
        # F1 rows carry psi^(i1*m2); T carries psi^(i2)
        F1 = (ppw[(i1 * m2) % (2 * M)][:, None]
              * pw[(m2 * np.outer(i1, i1)) % M]) % p     # [i1, k1]
        F2 = pw[(m1 * np.outer(i2, i2)) % M]             # [i2, k2]
        T = (ppw[i2 % (2 * M)][:, None]
             * pw[np.outer(i2, i1) % M]) % p             # [i2, k1]
        # inverse: Ti carries psi^(-i2); G1 columns carry M^-1 psi^(-i1*m2)
        G2 = pw[(-m1 * np.outer(i2, i2)) % M]            # [k2 dot]
        Ti = (ppw[(-i2) % (2 * M)][None, :]
              * pw[(-np.outer(i1, i2)) % M]) % p         # [k1, i2]
        G1 = (Minv * ppw[(-i1 * m2) % (2 * M)][None, :]
              * pw[(-m2 * np.outer(i1, i1)) % M]) % p    # [k1, i1]
        out.append({
            "p": p, "k": k, "m1": m1, "m2": m2,
            "F1": _plane_block(F1, p, k), "F2": _plane_block(F2, p, k),
            "G1": _plane_block(G1, p, k), "G2": _plane_block(G2, p, k),
            "T": T.astype(np.int32), "Ti": Ti.astype(np.int32),
        })
    return out


def _ntt4_tables(M: int):
    """The fused kernel's table list (6 arrays per prime, fixed order: F1,
    F2, G1, G2, T, Ti) and the static metas (p, k, m1, m2) per prime."""
    mats = _ntt4_mats(M)
    arrs, metas = [], []
    for mat in mats:
        arrs += [
            mat["F1"], mat["F2"], mat["G1"], mat["G2"],
            mat["T"], mat["Ti"],
        ]
        metas.append({k: mat[k] for k in ("p", "k", "m1", "m2")})
    return arrs, metas


@functools.lru_cache(maxsize=None)
def _garner_consts(primes: tuple[int, int, int]) -> dict:
    p1, p2, p3 = primes
    return {
        "inv12": pow(p1, -1, p2),
        "inv13": pow(p1, -1, p3),
        "inv23": pow(p2, -1, p3),
        "q": p1 * p2,
    }


def _col_major(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A square int8 block on `device`, stored column-major (a.t()
    contiguous): torch._int_mm on the card then takes cuBLASLt's fast int8
    layout, 7x faster at the 10^9-bit shape than a row-major block
    (chip_smoke.py prints both)."""
    return torch.from_numpy(a).to(device).t().contiguous().t()


@functools.lru_cache(maxsize=8)
def _blocks(M: int, device: torch.device) -> tuple[tuple[int, torch.Tensor, torch.Tensor], ...]:
    """Per prime (p, F, G): the dense tier's int8 plane blocks as
    column-major tensors on `device`, built once per (M, device).  At
    M = 2048 each is [4096, 4096] (16 MB)."""
    return tuple((m["p"], _col_major(m["F"], device), _col_major(m["G"], device))
                 for m in _matrices(M))


Ntt4Prime = collections.namedtuple("Ntt4Prime", "p F1 F2 G1 G2 T Ti")


@functools.lru_cache(maxsize=8)
def _ntt4_blocks(M: int, device: torch.device) -> tuple[Ntt4Prime, ...]:
    """Per prime of PRIMES_T2: the 4-step tables of _ntt4_mats on `device`,
    the four [3m, 3m] int8 plane blocks column-major (F1, G1 [3 m1, 3 m1],
    F2, G2 [3 m2, 3 m2]: [192, 192] and [384, 384] at most), T [m2, m1] and
    Ti [m1, m2] int32.  Built once per (M, device)."""
    return tuple(Ntt4Prime(m["p"], *(_col_major(m[k], device) for k in ("F1", "F2", "G1", "G2")),
                           *(torch.from_numpy(m[k]).to(device) for k in ("T", "Ti")))
                 for m in _ntt4_mats(M))


@functools.lru_cache(maxsize=8)
def _ntt4_fused_tables(M: int, device: torch.device) -> torch.Tensor:
    """_ntt4_tables(M) packed into one uint8 tensor for the fused kernel:
    per prime, in order, F1, F2, G1, G2 column-major int8, then T and Ti
    int32 (every piece a multiple of 16 bytes)."""
    arrs, _ = _ntt4_tables(M)
    parts = [np.ascontiguousarray(a.T if a.dtype == np.int8 else a).view(np.uint8).reshape(-1)
             for a in arrs]
    return torch.from_numpy(np.concatenate(parts)).to(device)


def _ntt4_shape(M: int) -> tuple[int, int]:
    """(m1, m2) of the 4-step split M = m1 m2, m1 = 2^(lg M // 2)."""
    m1 = 1 << ((M.bit_length() - 1) // 2)
    return m1, M // m1


# ---------------------------------------------------------------------------
# Device: exact integer helpers on [..., M] / [..., kM] tensors (the plain
# versions of csrc/ntt_links.cu are built from these)
# ---------------------------------------------------------------------------

def _balanced_pass(x: torch.Tensor) -> torch.Tensor:
    """One carry sweep recentering digits to ~[-2^15, 2^15], the top carry
    wrapping negated into digit 0.  From |digit| <= B the output bound is
    2^15 + B/2^16 + 1 (exact in the ring)."""
    m = (x + (1 << (DIGIT_BITS - 1))) >> DIGIT_BITS
    r = x - (m << DIGIT_BITS)
    return r + _wrap_inject(m)


def _center_mod(x: torch.Tensor, p: int) -> torch.Tensor:
    """Exact centered representative of x mod p, in [-(p-1)/2, (p-1)/2]."""
    r = torch.remainder(x, p)
    return torch.where(r > p // 2, r - p, r)


def _to_planes(x: torch.Tensor, p: int, k: int = 2) -> torch.Tensor:
    """[..., M] values -> [..., kM] signed-int8 planes [v0 | .. | v_(k-1)]
    of the centered residue rc mod p, rc = sum_j v_j 256^j, the low k-1
    balanced into [-128, 128)."""
    rc = _center_mod(x, p)
    planes = []
    for _ in range(k - 1):
        lo = ((rc + 128) & 255) - 128
        planes.append(lo)
        rc = (rc - lo) >> 8
    planes.append(rc)
    return torch.cat(planes, dim=-1).to(torch.int8)


def _fold_S(S: torch.Tensor, p: int, k: int = 2) -> torch.Tensor:
    """Raw plane sums [..., kM] = [S0 | .. | S_(k-1)] -> values
    sum_j 256^j S_j mod p in [0, p), [..., M], folded high to low
    (acc = (S_j + 256 acc) mod p), so every step stays int32-exact: the
    sums are below 2M 128^2 = 2^26 (dense tier) or 3m 128^2 < 2^22.6 (4-step
    tier), and 256 acc below 2^25.4."""
    M = S.shape[-1] // k
    acc = torch.remainder(S[..., (k - 1) * M:], p)
    for j in range(k - 2, -1, -1):
        acc = torch.remainder(S[..., j * M:(j + 1) * M] + (acc << 8), p)
    return acc


def _modmul(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """a * b mod p in [0, p), int32, through an exact int64 product (the
    tier-2 primes are above 2^16)."""
    return torch.remainder(a.to(torch.int64) * b, p).to(torch.int32)


def _dot_raw(planes: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    """[B, 2M] int8 planes @ [2M, 2M] int8 block -> raw int32 plane sums
    (exact: |S_j| <= 2M 128^2).  torch._int_mm on the card wants more than
    16 rows, so a short batch is padded with zero rows.  On the card each
    call counts as one "int8_gemm" launch."""
    rows = planes.shape[0]
    if rows <= 16:
        planes = torch.cat([planes, planes.new_zeros((32 - rows, planes.shape[1]))])
    out = torch._int_mm(planes, blk)[:rows]
    if out.is_cuda:
        kernels.LAUNCHES["int8_gemm"] += 1
    return out


def _garner(r1: torch.Tensor, r2: torch.Tensor, r3: torch.Tensor,
            primes: tuple[int, int, int] = PRIMES) -> torch.Tensor:
    """Residues in [0, p_j) -> the signed coefficient c (int64) with
    c == r_j mod p_j and |c| < P/2: mixed-radix digits
    c = v1 + p1 v2 + p1 p2 v3, the last one centered."""
    p1, p2, p3 = primes
    g = _garner_consts(primes)
    v1 = r1.to(torch.int64)
    v2 = torch.remainder(torch.remainder(r2 - v1, p2) * g["inv12"], p2)
    t = torch.remainder(torch.remainder(r3 - v1, p3) * g["inv13"], p3)
    v3 = torch.remainder(torch.remainder(t - v2, p3) * g["inv23"], p3)
    v3 = torch.where(v3 > p3 // 2, v3 - p3, v3)
    return v1 + p1 * v2 + g["q"] * v3


def _spread(c: torch.Tensor) -> torch.Tensor:
    """Signed coefficients c_i (|c| < 2^49.1) at digit i -> int32 digit sums
    s_i = c_i mod 2^16 + (c_(i-1) >> 16 mod 2^16) + (c_(i-2) >> 32), the
    pieces that pass the top wrapping negated (2^(16M) == -1).
    |s_i| < 2^17 + 2^12 for the dense tier's |c| < 2^44, < 2^18.2 for the
    4-step tier's; either way one carry pass then bounds the digits below
    2^16 + 2^12."""
    c0 = (c & 0xFFFF).to(torch.int32)
    c1 = ((c >> 16) & 0xFFFF).to(torch.int32)
    c2 = (c >> 32).to(torch.int32)
    return c0 + _wrap_inject(c1) + _wrap_inject(_wrap_inject(c2))


# ---------------------------------------------------------------------------
# The link kernels between the GEMMs (csrc/ntt_links.cu), tier 1: the three
# primes of PRIMES, two int8 planes [lo | hi] per value.  Each wrapper
# beside its plain version; a CPU tensor takes the plain version, a CUDA
# tensor launches the kernel or raises.
# ---------------------------------------------------------------------------

def input_planes_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the balanced carry pass of x (B, M), then per prime
    the planes of the centered residue -> (3, B, 2M) int8."""
    xb = _balanced_pass(x)
    return torch.stack([_to_planes(xb, p) for p in PRIMES])


def mid_planes_plain(sa: torch.Tensor, sb: torch.Tensor, p: int) -> torch.Tensor:
    """Plain version: fold both raw forward sums (B, 2M) mod p, multiply
    the centered values, the product's planes (B, 2M) int8."""
    fa = _center_mod(_fold_S(sa, p), p)
    fb = _center_mod(_fold_S(sb, p), p)
    return _to_planes(fa * fb, p)


def post_plain(d: torch.Tensor, post: tuple | None) -> torch.Tensor:
    """Plain version of the Garner kernels' post leg on (B, M) digits: for
    post = (K, steps), the inverse ladder group of stage exponents steps on
    each block of K rows (transforms.ifft_innermost_body); None: d."""
    if post is None:
        return d
    K, steps = post
    return ifft_innermost_body(d, steps, DIGIT_BITS * d.shape[-1], K)


def garner_carry_plain(s1: torch.Tensor, s2: torch.Tensor, s3: torch.Tensor,
                       post: tuple | None = None) -> torch.Tensor:
    """Plain version: fold the three raw inverse sums (B, 2M) to residues,
    Garner to the signed coefficients, spread into digits, one carry pass
    -> (B, M) int32; then the post leg (post_plain)."""
    r1, r2, r3 = (_fold_S(s, p) for s, p in zip((s1, s2, s3), PRIMES))
    return post_plain(carry_pass(_spread(_garner(r1, r2, r3))), post)


def _require_same(what: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    for y in others:
        if y.shape != x.shape or y.device != x.device:
            raise ValueError(f"{what}: operands differ: {tuple(x.shape)} on {x.device} "
                             f"vs {tuple(y.shape)} on {y.device}")


def _launch(name: str, fn, *args) -> None:
    """Call the C entry `fn` with `args` (the stream last), raise on its
    error code, else count one launch of kernel `name`."""
    rc = fn(*args)
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1


def _require_link(x: torch.Tensor, what: str, dtype: torch.dtype, width: int) -> int:
    """Check a (B, width * M) link operand; return M."""
    _require(x, what, ndim=2, dtype=dtype)
    M = x.shape[1] // width
    if x.shape[1] != width * M or M < 4 or M > TIER1_MAX_M or M & (M - 1):
        raise ValueError(f"{what}: shape {tuple(x.shape)} needs {width} x M columns, "
                         f"M a power of two in [4, {TIER1_MAX_M}]")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{what}: 16-byte aligned rows required")
    return M


def input_planes(x: torch.Tensor) -> torch.Tensor:
    """Balanced carry pass + per-prime plane conversion in one pass:
    x (B, M) int32 digits (|digit| <= 2^25) -> (3, B, 2M) int8, slab j the
    planes [lo | hi] of prime PRIMES[j] (the forward GEMMs' inputs)."""
    M = _require_link(x, "input_planes", torch.int32, 1)
    if x.device.type == "cpu":
        return input_planes_plain(x)
    B = x.shape[0]
    out = torch.empty((len(PRIMES), B, 2 * M), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        _launch("input_planes", kernels.lib().mf_input_planes, x.data_ptr(), out.data_ptr(), B,
                M, kernels.stream_of(x))
    return out


def mid_planes(sa: torch.Tensor, sb: torch.Tensor, p: int) -> torch.Tensor:
    """Fold both forward GEMM outputs, multiply mod p and replane for the
    inverse GEMM in one pass: sa, sb (B, 2M) raw int32 plane sums -> (B, 2M)
    int8 planes of (fa * fb) mod p."""
    M = _require_link(sa, "mid_planes", torch.int32, 2)
    _require_link(sb, "mid_planes", torch.int32, 2)
    _require_same("mid_planes", sa, sb)
    if p not in PRIMES:
        raise ValueError(f"mid_planes: p={p} is not one of {PRIMES}")
    if sa.device.type == "cpu":
        return mid_planes_plain(sa, sb, p)
    B = sa.shape[0]
    out = torch.empty(sa.shape, dtype=torch.int8, device=sa.device)
    with torch.cuda.device(sa.device):
        _launch("mid_planes", kernels.lib().mf_mid_planes, sa.data_ptr(), sb.data_ptr(),
                out.data_ptr(), B, M, PRIMES.index(p), kernels.stream_of(sa))
    return out


def _check_post(post: tuple | None, B: int, M: int, what: str) -> tuple:
    """The kernel arguments (K, steps array, k) of a post leg (0, None, 0
    for none); raise where the kernel cannot take it."""
    if post is None:
        return 0, None, 0
    K, steps = post
    k = len(steps)
    if k < 1 or K != 1 << k or B % K or not ladder_fits(K, M):
        raise ValueError(f"{what}: post leg K={K} with {k} stages on {B} rows of M={M}: K must "
                         f"be 2^stages, divide the rows and fit the ladder's buffer (ladder_fits)")
    return K, ctypes.cast(_steps_arg(steps), ctypes.c_void_p), k


def garner_carry(s1: torch.Tensor, s2: torch.Tensor, s3: torch.Tensor,
                 post: tuple | None = None) -> torch.Tensor:
    """The three primes' raw inverse GEMM sums (B, 2M) int32, in the order
    of PRIMES -> (B, M) bounded redundant digits (-2 <= d <= 2^16 + 1) of
    the negacyclic product: fold, Garner CRT, spread and carry in one pass.
    post = (K, steps): also the inverse ladder group of stage exponents
    steps on each block of K rows, in the same launch (the garner_post
    epilogue; counted as "garner_carry_post")."""
    M = _require_link(s1, "garner_carry", torch.int32, 2)
    for s in (s2, s3):
        _require_link(s, "garner_carry", torch.int32, 2)
    _require_same("garner_carry", s1, s2, s3)
    B = s1.shape[0]
    K, st, k = _check_post(post, B, M, "garner_carry")
    if s1.device.type == "cpu":
        return garner_carry_plain(s1, s2, s3, post)
    out = torch.empty((B, M), dtype=torch.int32, device=s1.device)
    with torch.cuda.device(s1.device):
        _launch("garner_carry_post" if K else "garner_carry", kernels.lib().mf_garner_carry,
                s1.data_ptr(), s2.data_ptr(), s3.data_ptr(), out.data_ptr(), B, M, K, st, k,
                kernels.stream_of(s1))
    return out


# ---------------------------------------------------------------------------
# The 4-step tier's links (csrc/ntt4.cu; Garner's residue form in
# csrc/ntt_links.cu): the primes of PRIMES_T2, three int8 planes per value.
# Layouts are the port's own: each link writes the rows the next
# torch._int_mm contracts, contraction last --
#   input planes, F1 sums, inverse-twiddle planes, G1 sums: (B*m2, 3*m1),
#     row (b, i2), column j*m1 + (i1 | k1);
#   forward-twiddle planes, F2 sums, pointwise planes, G2 sums: (B*m1, 3*m2),
#     row (b, k1), column j*m2 + (i2 | k2);
#   residues: (B, M), digit i1*m2 + i2.
# The twiddle links and the residue link transpose inside the row.  Each
# wrapper beside its plain version; a CPU tensor takes the plain version, a
# CUDA tensor launches the kernel or raises.
# ---------------------------------------------------------------------------

def _ntt4_prime(M: int, device: torch.device, p: int) -> Ntt4Prime:
    return _ntt4_blocks(M, device)[PRIMES_T2.index(p)]


def ntt4_input_planes_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the balanced carry pass of x (B, M), then per prime
    the three planes of the centered residues in [i2, i1] order ->
    (3, B*m2, 3*m1) int8."""
    B, M = x.shape
    m1, m2 = _ntt4_shape(M)
    xb = _balanced_pass(x).reshape(B, m1, m2).transpose(1, 2)
    return torch.stack([_to_planes(xb, p, 3).reshape(B * m2, 3 * m1) for p in PRIMES_T2])


def _twiddle_plain(S: torch.Tensor, tab: torch.Tensor, p: int) -> torch.Tensor:
    """Fold the raw sums S (B*R, 3C) to values [B, R, C], times tab [R, C]
    mod p, transposed, replaned -> (B*C, 3R) int8."""
    R, C = tab.shape
    v = _modmul(_fold_S(S, p, 3).reshape(-1, R, C), tab, p).transpose(1, 2)
    return _to_planes(v, p, 3).reshape(-1, 3 * R)


def ntt4_fwd_twiddle_plain(S: torch.Tensor, p: int, M: int) -> torch.Tensor:
    """Plain version of the reference's k_mid1: F1 sums (B*m2, 3*m1) ->
    planes (B*m1, 3*m2) of the values times T, transposed i2 <-> k1."""
    return _twiddle_plain(S, _ntt4_prime(M, S.device, p).T, p)


def ntt4_pointwise_plain(Sa: torch.Tensor, Sb: torch.Tensor, p: int, M: int) -> torch.Tensor:
    """Plain version of the reference's k_pw: both operands' F2 sums
    (B*m1, 3*m2) folded, multiplied mod p -> the product's planes, same
    layout."""
    return _to_planes(_modmul(_fold_S(Sa, p, 3), _fold_S(Sb, p, 3), p), p, 3)


def ntt4_inv_twiddle_plain(S: torch.Tensor, p: int, M: int) -> torch.Tensor:
    """Plain version of the reference's k_mid3: G2 sums (B*m1, 3*m2) ->
    planes (B*m2, 3*m1) of the values times Ti, transposed k1 <-> i2."""
    return _twiddle_plain(S, _ntt4_prime(M, S.device, p).Ti, p)


def ntt4_residues_plain(S: torch.Tensor, p: int, M: int) -> torch.Tensor:
    """Plain version of the reference's k_out: G1 sums (B*m2, 3*m1) ->
    residues in [0, p) in digit order (B, M)."""
    m1, m2 = _ntt4_shape(M)
    return _fold_S(S, p, 3).reshape(-1, m2, m1).transpose(1, 2).reshape(-1, M)


def garner_residues_plain(r1: torch.Tensor, r2: torch.Tensor, r3: torch.Tensor,
                          post: tuple | None = None) -> torch.Tensor:
    """Plain version: the residues (B, M) of the three tier-2 primes ->
    Garner's signed coefficients, spread into digits, one carry pass ->
    (B, M) int32; then the post leg (post_plain)."""
    return post_plain(carry_pass(_spread(_garner(r1, r2, r3, PRIMES_T2))), post)


def _ntt4_leg(pa: torch.Tensor, pb: torch.Tensor | None, blk: Ntt4Prime, M: int,
              plain: bool = False) -> torch.Tensor:
    """One prime's negacyclic product through the 4-step tier: the
    operands' input planes (B*m2, 3*m1) (pb None: a square) -> residues
    (B, M) in [0, p).  Six int8 GEMMs (four for a square); the links are
    the kernels' wrappers, or their plain versions."""
    if plain:
        links = (ntt4_fwd_twiddle_plain, ntt4_pointwise_plain, ntt4_inv_twiddle_plain,
                 ntt4_residues_plain)
    else:
        links = (ntt4_fwd_twiddle, ntt4_pointwise, ntt4_inv_twiddle, ntt4_residues)
    fwd_twiddle, pointwise, inv_twiddle, residues = links
    p = blk.p

    def forward(planes):
        return _dot_raw(fwd_twiddle(_dot_raw(planes, blk.F1), p, M), blk.F2)

    Sa = forward(pa)
    Sb = Sa if pb is None else forward(pb)
    pp = pointwise(Sa, Sb, p, M)
    del Sa, Sb
    return residues(_dot_raw(inv_twiddle(_dot_raw(pp, blk.G2), p, M), blk.G1), p, M)


def ntt4_fused_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused kernel: the whole 3-prime 4-step
    pipeline on (B, M) digits (b is a: a square) -> the three primes'
    residue rows (3, B, M) in [0, p)."""
    M = a.shape[1]
    pa = ntt4_input_planes_plain(a)
    pb = None if b is a else ntt4_input_planes_plain(b)
    return torch.stack([_ntt4_leg(pa[i], None if pb is None else pb[i], blk, M, plain=True)
                        for i, blk in enumerate(_ntt4_blocks(M, a.device))])


def _t2_shape(M: int, what: str) -> tuple[int, int]:
    """(m1, m2) of a 4-step ring; raise for any other M."""
    if not (TIER1_MAX_M < M <= NTT_MAX_M and ntt_supported(M)):
        raise ValueError(f"{what}: M={M} is not a 4-step ring (a power of two in "
                         f"({TIER1_MAX_M}, {NTT_MAX_M}])")
    return _ntt4_shape(M)


def _require_t2(x: torch.Tensor, what: str, dtype: torch.dtype, M: int, rows: int,
                cols: int) -> int:
    """Check a (n * rows, cols) link operand of a 4-step ring; return n."""
    _require(x, what, ndim=2, dtype=dtype)
    _t2_shape(M, what)
    if x.shape[1] != cols or x.shape[0] % rows:
        raise ValueError(f"{what}: shape {tuple(x.shape)} needs a multiple of {rows} rows "
                         f"of {cols} columns at M={M}")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{what}: 16-byte aligned rows required")
    return x.shape[0] // rows


def _require_prime(p: int, what: str) -> int:
    if p not in PRIMES_T2:
        raise ValueError(f"{what}: p={p} is not one of {PRIMES_T2}")
    return PRIMES_T2.index(p)


def ntt4_input_planes(x: torch.Tensor) -> torch.Tensor:
    """Balanced carry pass + the three primes' planes in one pass (the
    reference's _ntt4_input_planes body): x (B, M) int32 digits
    (|digit| <= 2^25) -> (3, B*m2, 3*m1) int8, slab j the F1 GEMM's input
    for prime PRIMES_T2[j]."""
    _require(x, "ntt4_input_planes", ndim=2, dtype=torch.int32)
    M = x.shape[1]
    m1, m2 = _t2_shape(M, "ntt4_input_planes")
    B = _require_t2(x, "ntt4_input_planes", torch.int32, M, 1, M)
    if x.device.type == "cpu":
        return ntt4_input_planes_plain(x)
    out = torch.empty((len(PRIMES_T2), B * m2, 3 * m1), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        _launch("ntt4_input_planes", kernels.lib().mf_ntt4_input_planes, x.data_ptr(),
                out.data_ptr(), B, M, kernels.stream_of(x))
    return out


def _ntt4_twiddle(S: torch.Tensor, p: int, M: int, inverse: bool) -> torch.Tensor:
    name = "ntt4_inv_twiddle" if inverse else "ntt4_fwd_twiddle"
    m1, m2 = _t2_shape(M, name)
    R, C = (m1, m2) if inverse else (m2, m1)
    B = _require_t2(S, name, torch.int32, M, R, 3 * C)
    j = _require_prime(p, name)
    blk = _ntt4_prime(M, S.device, p)
    tab = blk.Ti if inverse else blk.T
    if S.device.type == "cpu":
        return _twiddle_plain(S, tab, p)
    out = torch.empty((B * C, 3 * R), dtype=torch.int8, device=S.device)
    with torch.cuda.device(S.device):
        _launch(name, kernels.lib().mf_ntt4_twiddle, S.data_ptr(), tab.data_ptr(),
                out.data_ptr(), B, R, C, j, int(inverse), kernels.stream_of(S))
    return out


def ntt4_fwd_twiddle(S: torch.Tensor, p: int, M: int) -> torch.Tensor:
    """The reference's k_mid1 in one pass: F1 sums (B*m2, 3*m1) int32 ->
    fold, times T mod p, transpose i2 <-> k1, replane -> (B*m1, 3*m2) int8."""
    return _ntt4_twiddle(S, p, M, inverse=False)


def ntt4_inv_twiddle(S: torch.Tensor, p: int, M: int) -> torch.Tensor:
    """The reference's k_mid3 in one pass: G2 sums (B*m1, 3*m2) int32 ->
    fold, times Ti mod p, transpose k1 <-> i2, replane -> (B*m2, 3*m1) int8."""
    return _ntt4_twiddle(S, p, M, inverse=True)


def ntt4_pointwise(Sa: torch.Tensor, Sb: torch.Tensor, p: int, M: int) -> torch.Tensor:
    """The reference's k_pw in one pass: both operands' F2 sums
    (B*m1, 3*m2) int32 -> fold, multiply mod p, replane -> (B*m1, 3*m2)
    int8 (Sb may be Sa: a square)."""
    m1, m2 = _t2_shape(M, "ntt4_pointwise")
    B = _require_t2(Sa, "ntt4_pointwise", torch.int32, M, m1, 3 * m2)
    _require_t2(Sb, "ntt4_pointwise", torch.int32, M, m1, 3 * m2)
    _require_same("ntt4_pointwise", Sa, Sb)
    j = _require_prime(p, "ntt4_pointwise")
    if Sa.device.type == "cpu":
        return ntt4_pointwise_plain(Sa, Sb, p, M)
    out = torch.empty(Sa.shape, dtype=torch.int8, device=Sa.device)
    with torch.cuda.device(Sa.device):
        _launch("ntt4_pointwise", kernels.lib().mf_ntt4_pointwise, Sa.data_ptr(),
                Sb.data_ptr(), out.data_ptr(), B * m1, m2, j, kernels.stream_of(Sa))
    return out


def ntt4_residues(S: torch.Tensor, p: int, M: int) -> torch.Tensor:
    """The reference's k_out in one pass: G1 sums (B*m2, 3*m1) int32 ->
    residues in [0, p), transposed to digit order -> (B, M) int32."""
    m1, m2 = _t2_shape(M, "ntt4_residues")
    B = _require_t2(S, "ntt4_residues", torch.int32, M, m2, 3 * m1)
    j = _require_prime(p, "ntt4_residues")
    if S.device.type == "cpu":
        return ntt4_residues_plain(S, p, M)
    out = torch.empty((B, M), dtype=torch.int32, device=S.device)
    with torch.cuda.device(S.device):
        _launch("ntt4_residues", kernels.lib().mf_ntt4_residues, S.data_ptr(), out.data_ptr(),
                B, M, j, kernels.stream_of(S))
    return out


def garner_residues(r1: torch.Tensor, r2: torch.Tensor, r3: torch.Tensor,
                    post: tuple | None = None) -> torch.Tensor:
    """Garner's residue form (the reference's _garner_carry with
    raw_k=None): the residues (B, M) int32 in [0, p) of the three tier-2
    primes, in the order of PRIMES_T2 -> (B, M) bounded redundant digits
    (-5 <= d <= 2^16 + 4) of the negacyclic product in one pass.  post: as
    garner_carry's (counted as "garner_residues_post")."""
    _require(r1, "garner_residues", ndim=2, dtype=torch.int32)
    M = r1.shape[1]
    B = _require_t2(r1, "garner_residues", torch.int32, M, 1, M)
    for r in (r2, r3):
        _require_t2(r, "garner_residues", torch.int32, M, 1, M)
    _require_same("garner_residues", r1, r2, r3)
    K, st, k = _check_post(post, B, M, "garner_residues")
    if r1.device.type == "cpu":
        return garner_residues_plain(r1, r2, r3, post)
    out = torch.empty((B, M), dtype=torch.int32, device=r1.device)
    with torch.cuda.device(r1.device):
        _launch("garner_residues_post" if K else "garner_residues",
                kernels.lib().mf_garner_residues, r1.data_ptr(), r2.data_ptr(), r3.data_ptr(),
                out.data_ptr(), B, M, K, st, k, kernels.stream_of(r1))
    return out


def ntt4_fused(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The whole 3-prime 4-step pipeline per row in one kernel (the
    reference's _fused_mulmod_fn kernel_ntt): digits a, b (B, M) int32 (b
    is a: a square) -> the three primes' residue rows (3, B, M) in [0, p),
    digit order; garner_residues finishes the product."""
    _require(a, "ntt4_fused", ndim=2, dtype=torch.int32)
    M = a.shape[1]
    B = _require_t2(a, "ntt4_fused", torch.int32, M, 1, M)
    _require_t2(b, "ntt4_fused", torch.int32, M, 1, M)
    _require_same("ntt4_fused", a, b)
    if a.device.type == "cpu":
        return ntt4_fused_plain(a, b)
    out = torch.empty((len(PRIMES_T2), B, M), dtype=torch.int32, device=a.device)
    tables = _ntt4_fused_tables(M, a.device)
    with torch.cuda.device(a.device):
        _launch("ntt4_fused", kernels.lib().mf_ntt4_fused, a.data_ptr(), b.data_ptr(),
                tables.data_ptr(), out.data_ptr(), B, M, kernels.stream_of(a))
    return out


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------

# The garner_post hook (the reference's ntt.py:445-462): (M, K, steps,
# consumed cell), set by the staged flagship around its pointwise so that
# the chunk's innermost inverse ladder group runs inside the Garner kernel.
_GARNER_POST = contextvars.ContextVar("mpir_fft_torch_garner_post", default=None)


@contextlib.contextmanager
def garner_post(M: int, K: int, steps):
    """Ask the Garner step of a pointwise on rings of exactly M digits to
    apply the inverse ladder group of stage exponents `steps` (K = 2^len)
    to each block of K rows before it writes them.  Yields a dict whose
    'consumed' becomes True if a Garner launch (either tier) took it; the
    schoolbook leaf and the recursive mulmod never do, and then the caller
    runs the leg itself.  Whether it is taken is a shape rule decided
    before the launch: the ring is M digits and K divides the rows."""
    cell = {"consumed": False}
    tok = _GARNER_POST.set((M, K, tuple(int(s) for s in steps), cell))
    try:
        yield cell
    finally:
        _GARNER_POST.reset(tok)


def _take_post(B: int, M: int) -> tuple | None:
    """The hook's (K, steps) if it applies to a pointwise of B rows of M
    digits (marking it consumed), else None."""
    hook = _GARNER_POST.get()
    if hook is None or hook[0] != M or B % hook[1]:
        return None
    hook[3]["consumed"] = True
    return hook[1], hook[2]


# The 4-step tier runs the batch in row chunks whose largest int32 GEMM
# output (Bc*m rows of 3m' sums, 12 Bc M bytes) stays under this many bytes:
# the port's counterpart of the reference's _PW_CHUNK_BYTES (models/mul.py),
# sized for an 80 GB card.  At the 2x10^9-bit plan's (131072, 4096) batch
# that is 4 chunks of 32768 rows; unchunked, the GEMM outputs alone would
# take 6 GiB each.
NTT4_CHUNK_BYTES = 2 << 30


def _mulmod_dense(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The dense tier on (B, M) rows (y is x: a square): the flow of the
    reference's link-fused dense tier (ntt.py:1000-1015) -- input_planes
    per operand, per prime two forward GEMMs, mid_planes and one inverse
    GEMM, then garner_carry on the three raw inverse sums (with the
    garner_post leg where the hook applies)."""
    B, M = x.shape
    pa = input_planes(x)
    pb = pa if y is x else input_planes(y)
    parts = []
    for i, (p, F, G) in enumerate(_blocks(M, x.device)):
        Sa = _dot_raw(pa[i], F)
        Sb = Sa if y is x else _dot_raw(pb[i], F)
        pp = mid_planes(Sa, Sb, p)
        del Sa, Sb
        parts.append(_dot_raw(pp, G))
    return garner_carry(*parts, post=_take_post(B, M))


def _mulmod_4step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The 4-step tier on (B, M) rows (y is x: a square), chunk by chunk
    (NTT4_CHUNK_BYTES): per operand ntt4_input_planes, per prime the
    forward legs (F1 GEMM, ntt4_fwd_twiddle, F2 GEMM), ntt4_pointwise, the
    inverse leg (G2 GEMM, ntt4_inv_twiddle, G1 GEMM, ntt4_residues), then
    garner_residues (the flow of ntt.py:1027-1046; with the garner_post
    leg where the hook applies, the chunks whole K-row blocks).  With
    MPIR_FFT_NTT_FUSED=1 (read at call time) each chunk's residues come
    from the fused kernel instead (ntt.py:978-989)."""
    B, M = x.shape
    square = y is x
    fused = os.environ.get("MPIR_FFT_NTT_FUSED", "0") == "1"
    rows = max(1, NTT4_CHUNK_BYTES // (12 * M))
    post = _take_post(B, M)
    if post is not None:                    # chunks of whole K-row blocks
        rows = max(post[0], rows - rows % post[0])
    out = []
    for s in range(0, B, rows):
        xa = x[s:s + rows]
        xb = xa if square else y[s:s + rows]
        if fused:
            res = ntt4_fused(xa, xb)
        else:
            pa = ntt4_input_planes(xa)
            pb = None if square else ntt4_input_planes(xb)
            res = [_ntt4_leg(pa[i], None if pb is None else pb[i], blk, M)
                   for i, blk in enumerate(_ntt4_blocks(M, x.device))]
            del pa, pb
        out.append(garner_residues(*res, post=post))
        del res
    return out[0] if len(out) == 1 else torch.cat(out)


def gemm_ops(B: int, M: int) -> int:
    """int8 operations (two a multiply-add) of the GEMMs mulmod_ntt issues
    for B products of M-digit rings: per prime two forward transforms and
    one inverse, each one [B, 2M] @ [2M, 2M] GEMM on the dense tier, an
    [B m2, 3 m1] @ [3 m1, 3 m1] and an [B m1, 3 m2] @ [3 m2, 3 m2] GEMM on
    the 4-step tier; batches of up to 16 rows padded to 32, as _dot_raw
    pads them."""
    def mm(rows: int, k: int) -> int:
        return 2 * (32 if rows <= 16 else rows) * k * k

    if M <= TIER1_MAX_M:
        return 3 * 3 * mm(B, 2 * M)
    m1, m2 = _ntt4_shape(M)
    return 3 * 3 * (mm(B * m2, 3 * m1) + mm(B * m1, 3 * m2))


def mulmod_ntt(a: torch.Tensor, b: torch.Tensor, canonical: bool = False) -> torch.Tensor:
    """(a * b) mod 2^(16M)+1 on digit vectors [..., M] (broadcast), M a
    power of two in [4, 8192]: the dense tier up to M = 2048, the 4-step
    tier above.  Inputs may be redundant (|digit| <= 2^25); the output is
    bounded redundant digits (|d| < 2^16 + 2^12) unless canonical=True.
    `b is a` (a square) transforms once."""
    M = a.shape[-1]
    if not ntt_supported(M):
        raise ValueError(f"mulmod_ntt: M={M} must be a power of two in [4, {NTT_MAX_M}]")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    x = a.expand(shape).reshape(-1, M).contiguous()
    y = x if b is a else b.expand(shape).reshape(-1, M).contiguous()
    d = (_mulmod_dense if M <= TIER1_MAX_M else _mulmod_4step)(x, y).reshape(shape)
    return normmod(d) if canonical else d
