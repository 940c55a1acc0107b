"""The port's CUDA kernels against their plain torch versions, on the card.

Needs an NVIDIA GPU with nvcc: every test skips elsewhere.  Imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Canonical outputs must be equal; redundant outputs equal after normmod.
All arithmetic is integer, so the tolerance is exact."""

import random

import numpy as np
import pytest
import torch

from mpir_fft_tpu_torch import kernels, mulmod_int
from mpir_fft_tpu_torch.models import huge
from mpir_fft_tpu_torch.models.mul import (DRIVERS, _staged_flagship, flagship_is_staged,
                                           mpn_mul_flagship, mpn_sqr_flagship, mul, mul_many,
                                           sqr)
from mpir_fft_tpu_torch.ops.fused import (
    _affine_half_exps,
    CANON_ROW_MAX,
    CANON_TILE,
    canonicalize_plain_torch,
    fused_butterfly_ladder,
    fused_canonicalize_plain,
    fused_mfa_cols,
    fused_normmod_div,
    fused_sqrt2_top_fwd,
    fused_sqrt2_top_inv,
    fused_transform,
    fused_twiddle_half,
    ladder_plain,
    ladder_stages,
    mfa_col_fits,
    mfa_cols_plain,
    NORMMOD_LONG_MAX,
    NORMMOD_ROW_MAX,
    NORMMOD_SHORT_MAX,
    normmod_route,
    normmod_rows_plain,
    sqrt2_top_fwd_plain,
    sqrt2_top_inv_plain,
    transform_plain,
    twiddle_half_rows_plain,
)
from mpir_fft_tpu_torch.ops.limb import digits_from_int, int_from_digits
from mpir_fft_tpu_torch.ops.ntt import (
    PRIMES,
    PRIMES_T2,
    _blocks,
    _dot_raw,
    _ntt4_blocks,
    garner_carry,
    garner_carry_plain,
    garner_residues,
    garner_residues_plain,
    input_planes,
    input_planes_plain,
    mid_planes,
    mid_planes_plain,
    mulmod_ntt,
    ntt4_fused,
    ntt4_fused_plain,
    ntt4_fwd_twiddle,
    ntt4_fwd_twiddle_plain,
    ntt4_input_planes,
    ntt4_input_planes_plain,
    ntt4_inv_twiddle,
    ntt4_inv_twiddle_plain,
    ntt4_pointwise,
    ntt4_pointwise_plain,
    ntt4_residues,
    ntt4_residues_plain,
)
from mpir_fft_tpu_torch.ops.pointwise import conv_base_plain
from mpir_fft_tpu_torch.ops.transforms import ifft_innermost_body
from mpir_fft_tpu_torch.ops.pointwise_fused import mulmod_base_fused
from mpir_fft_tpu_torch.utils.ladder_bench import huge_passes
from mpir_fft_tpu_torch.utils.params import MulPlan, choose_params, plan_for_depth, validate

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _rand(rng, shape, lo, hi, dev):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32)).to(dev)


def _canon(x):
    L = x.shape[-1]
    return normmod_rows_plain(x.reshape(-1, L).cpu(), 0, 16 * L)


def _main_K(K, L):
    """K, or (0) the main path's K at width L: 2^ladder_stages(L)."""
    return K or 1 << ladder_stages(L)


# K 0: the main path's group at that width (L 1024, 2048, 3072, 4096)
@pytest.mark.parametrize("kind", ["fwd", "inv"])
@pytest.mark.parametrize("shape,w", [
    ((2, 16, 8, 32), 1), ((3, 4, 5, 71), 7), ((1, 8, 2, 2048), 2), ((4, 2, 1, 16), 3),
    ((2, 0, 3, 1024), 1), ((1, 0, 4, 2048), 2), ((1, 0, 3, 3072), 24), ((1, 0, 2, 4096), 2),
    ((1, 2, 1, 8192), 1), ((1, 2, 1, 4099), 1),
])
def test_ladder_matches_plain(dev, kind, shape, w):
    """The ladder against ladder_plain: raw digits identical (and so equal
    after normmod), below 2^17; launches count under ladder."""
    rng = np.random.default_rng(1)
    N, K, h, L = shape
    K = _main_K(K, L)
    shape = (N, K, h, L)
    W = 16 * L
    k = K.bit_length() - 1
    steps = tuple(w << (3 + j) for j in range(k))
    x = _rand(rng, shape, -(1 << 17), 1 << 17, dev)
    before = kernels.LAUNCHES["ladder"]
    got = fused_butterfly_ladder(kind, x, steps, W)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ladder"] == before + 1
    want = ladder_plain(kind, x.cpu(), steps, W)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(_canon(got), _canon(want))
    assert int(got.abs().max()) < 1 << 17


@pytest.mark.parametrize("kind", ["fwd", "inv"])
def test_ladder_unaligned_rows_match_plain(dev, kind):
    """A view whose rows are not 16-byte aligned takes the kernel's
    one-digit runs: raw digits identical to ladder_plain."""
    rng = np.random.default_rng(2)
    N, K, h, L = 2, 8, 3, 256
    W = 16 * L
    steps = (5, 10, 20)
    flat = _rand(rng, (N * K * h * L + 1,), -(1 << 17), 1 << 17, dev)
    x = flat[1:].view(N, K, h, L)
    assert x.data_ptr() % 16
    got = fused_butterfly_ladder(kind, x, steps, W)
    assert torch.equal(got.cpu(), ladder_plain(kind, x.cpu(), steps, W))


CONV_LO, CONV_HI = -(1 << 6), (1 << 16) + (1 << 6)   # conv_base's output bound (exclusive)


def _conv_check(a, b):
    """mulmod_base_fused on the card against conv_base_plain: equal after
    normmod, digits inside the kernel's bound."""
    got = _launched("conv_base", lambda: mulmod_base_fused(a, b))
    want = conv_base_plain(a.cpu(), b.cpu())
    assert torch.equal(_canon(got), _canon(want)), tuple(a.shape)
    assert CONV_LO < int(got.min()) and int(got.max()) < CONV_HI, tuple(a.shape)


# L 32 / 48 / 72: the inner rings of the main path's plans; row counts of 1,
# 7 and 1003, which no rows-per-CTA count divides; L 128-1024 the
# MPIR_FFT_NTT=0 plans' outer rings, 2047 / 2048 the widest block rows
@pytest.mark.parametrize("B,L", [(5, 1), (7, 16), (3, 71), (4, 126), (9, 512), (2, 2048)] + [
    (B, L) for L in (32, 48, 72) for B in (1, 7, 1003)] + [
    (33, 128), (17, 256), (7, 512), (5, 1024), (3, 2047)])
def test_conv_base_matches_plain(dev, B, L):
    rng = np.random.default_rng(2)
    _conv_check(_rand(rng, (B, L), -(1 << 17), 1 << 17, dev),
                _rand(rng, (B, L), -(1 << 17), 1 << 17, dev))


def test_conv_base_every_short_width_matches_plain(dev):
    """Every L 1..130, rows 16-byte aligned and not (int4 or one-digit
    runs), and the short / block boundary on both sides: each layout the C
    side picks from L (the outputs a lane owns, the lanes a row, padded
    steps) gives the plain version's values."""
    rng = np.random.default_rng(10)
    short_max = kernels.lib().mf_conv_base_short_max()
    for L in list(range(1, 131)) + [short_max - 1, short_max, short_max + 1, short_max + 8]:
        a = _rand(rng, (3, L), -(1 << 17), 1 << 17, dev)
        b = _rand(rng, (3, L), -(1 << 17), 1 << 17, dev)
        _conv_check(a, b)
        fa = torch.empty(3 * L + 1, dtype=torch.int32, device=dev)
        fb = torch.empty(3 * L + 1, dtype=torch.int32, device=dev)
        fa[1:] = a.reshape(-1)
        fb[1:] = b.reshape(-1)
        _conv_check(fa[1:].view(3, L), fb[1:].view(3, L))


@pytest.mark.parametrize("L", [48, 2048])
def test_conv_base_extreme_rows_match_oracle(dev, L):
    """Rows at the extreme magnitudes (all +2^17, all -2^17, alternating
    signs, the -1 form), every pair, against Python's product mod
    2^(16L)+1: the fp64 sums reach L 2^34."""
    e = 1 << 17
    alt = np.where(np.arange(L) % 2 == 0, e, -e)
    minus_one = np.zeros(L, np.int64)
    minus_one[0] = -1
    x = np.stack([np.full(L, e), np.full(L, -e), alt, -alt, minus_one]).astype(np.int32)
    a, b = np.repeat(x, len(x), axis=0), np.tile(x, (len(x), 1))
    got = _launched("conv_base", lambda: mulmod_base_fused(
        torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))).cpu()
    assert CONV_LO < int(got.min()) and int(got.max()) < CONV_HI
    p = (1 << (16 * L)) + 1
    for r in range(len(a)):
        assert int_from_digits(got[r].numpy()) % p == \
            int_from_digits(a[r]) * int_from_digits(b[r]) % p, r


def _normmod_inputs(rng, B, L):
    """B random rows with the ripple edge rows spread over the batch (the
    last one in the last row); for B < 4 each edge row also alone."""
    x = rng.integers(-(1 << 29), 1 << 29, (B, L)).astype(np.int32)
    e = np.zeros((4, L), np.int32)
    e[0] = 0xFFFF               # +1 ripple through every digit -> -1 form
    e[2, 0] = -1                # the -1 form itself
    e[3, -1] = 1 << 16          # carry out of the top digit
    if B < 4:
        return [x] + [e[k:k + 1] for k in range(4)]
    x[[0, B // 3, 2 * B // 3, B - 1]] = e
    return [x]


def _normmod_counter(L):
    return "normmod_long" if normmod_route(L) == "long" else "normmod"


@pytest.mark.parametrize("L,B", [
    (L, B) for L in (1, 16, 32, 48, 64, 71, 72, 128, 256, 512, 2048, 2049, 3072, 5120, 6144,
                      8192)
    for B in (1, 7, 1003)] + [(8193, 8), (20000, 8)] + [
    (10 * 2048 + k, 3) for k in (-1, 0, 1)] + [(1 << 18, 1), (1 << 20, 2), (1 << 25, 1)])
def test_normmod_matches_plain(dev, L, B):
    """Every route (ops/fused.normmod_route): short rows up to 512 digits
    (several a warp), block rows up to 8192 (one CTA each), L > 8192 the
    chained scan over 2048-digit tiles (a partial last tile, the mulmod_int
    rings' 2^18, 2^20 and 2^25 digits); batches that no rows-per-CTA count
    divides; odd L (one-digit runs).  The plain version runs on the card
    (the same integer ops as on the host)."""
    rng = np.random.default_rng(3)
    W = 16 * L
    for x in _normmod_inputs(rng, B, L):
        xd = torch.from_numpy(x).to(dev)
        for s in sorted({0, 1, 15, 16, 17, W - 1, W, W + 5, 2 * W - 14, 2 * W - 1}):
            if not 0 <= s < 2 * W:
                continue
            got = _launched(_normmod_counter(L), lambda: fused_normmod_div(xd, s, W))
            assert torch.equal(got, normmod_rows_plain(xd, s, W)), (s, normmod_route(L))


def _ripple_rows(rng, B, L, kind):
    """Long rows whose carry out ripples back from digit 0: "ones" every
    digit 0xFFFF, the top one -1 (carry out -1: the +1 runs through the whole
    row into the -1 form, and every tile looks back); "ones_stop" leading
    0xFFFF over three tiles, then a stop; "zeros" leading zeros, carry out
    +1 (a -1 ripple); "mixed" B rows of those three and a random one."""
    x = rng.integers(0, 1 << 16, (B, L)).astype(np.int32)
    if kind == "ones":
        x[:] = 0xFFFF
        x[:, -1] = -1
    elif kind == "ones_stop":
        x[:, :5000] = 0xFFFF
        x[:, 5000] = 5
        x[:, -1] = -1
    elif kind == "zeros":
        x[:, :3000] = 0
        x[:, 3000] = 7
        x[:, -1] += 1 << 16
    else:
        for r, k in enumerate(("ones", "ones_stop", "zeros")):
            x[r] = _ripple_rows(rng, 1, L, k)[0]
    return x


@pytest.mark.parametrize("kind,B,L", [
    ("ones", 1, 10 * 2048 + 1), ("ones", 2, 1 << 18), ("ones", 1, 1 << 25),
    ("ones_stop", 1, 1 << 18), ("zeros", 1, 1 << 18), ("zeros", 2, 20000),
    ("mixed", 4, 20480), ("mixed", 4, 1 << 20)])
def test_normmod_long_ripples(dev, kind, B, L):
    """The long route's carry-out fold: the -1 form from an all-0xFFFF row,
    ripples that stop after three tiles, leading zeros with carry out +1, and
    in a batch each ripple in its own row only; digits identical to the
    plain version."""
    x = torch.from_numpy(_ripple_rows(np.random.default_rng(11), B, L, kind)).to(dev)
    W = 16 * L
    for s in (0, W + 3):
        got = _launched("normmod_long", lambda: fused_normmod_div(x, s, W))
        assert torch.equal(got, normmod_rows_plain(x, s, W)), (kind, s)
    got = fused_normmod_div(x, 0, W)
    if kind in ("ones", "mixed"):      # the -1 form
        assert int(got[0, 0]) == -1 and not bool(got[0, 1:].any())


@pytest.mark.parametrize("L", [20481, 1 << 18])
def test_normmod_long_unaligned(dev, L):
    """Long rows with one-digit runs (V 1): rows one word off 16-byte
    alignment, and L % 4 != 0; digits identical to the plain version."""
    rng = np.random.default_rng(12)
    W = 16 * L
    flat = _rand(rng, (2 * L + 1,), -(1 << 29), 1 << 29, dev)
    flat[1 + L:1 + 2 * L] = torch.from_numpy(_ripple_rows(rng, 1, L, "ones")[0]).to(dev)
    x = flat[1:].view(2, L)
    assert x.data_ptr() % 16
    for s in (0, 5, W + 17):
        got = _launched("normmod_long", lambda: fused_normmod_div(x, s, W))
        assert torch.equal(got, normmod_rows_plain(x, s, W)), s


@pytest.mark.parametrize("kind,B,L", [("ones", 3, 1 << 18), ("ones", 1, 1 << 20),
                                      ("random", 1, 1 << 25)])
def test_normmod_long_repeatable(dev, kind, B, L):
    """50 launches on one input give identical digits (a race in the
    look-back or the fold would show as a launch that differs)."""
    rng = np.random.default_rng(13)
    x = _rand(rng, (B, L), -(1 << 29), 1 << 29, dev) if kind == "random" else \
        torch.from_numpy(_ripple_rows(rng, B, L, kind)).to(dev)
    W = 16 * L
    first = fused_normmod_div(x, 0, W)
    assert torch.equal(first, normmod_rows_plain(x, 0, W))
    for k in range(50):
        assert torch.equal(fused_normmod_div(x, 0, W), first), k


@pytest.mark.parametrize("B,L", [(1, 8192), (3, 8193), (1, 1 << 18), (2, 10 * 2048 + 1),
                                 (1, 1 << 25)])
def test_normmod_scratch_matches_wrapper(dev, monkeypatch, B, L):
    """mf_normmod_scratch(B, L): none up to NORMMOD_ROW_MAX, else a ticket,
    a status word a 2048-digit tile and two words a row -- and exactly what
    fused_normmod_div allocates beside its output (no (2, B, L) buffer)."""
    want = 0 if L <= NORMMOD_ROW_MAX else B * -(-L // 2048) + 2 * B + 1
    assert kernels.lib().mf_normmod_scratch(B, L) == want
    x = torch.zeros((B, L), dtype=torch.int32, device=dev)
    sizes, empty = [], torch.empty

    def spy(*shape, **kw):
        t = empty(*shape, **kw)
        sizes.append(t.numel())
        return t

    monkeypatch.setattr(torch, "empty", spy)
    fused_normmod_div(x, 0, 16 * L)
    assert sizes == ([want] if want else []), sizes


@pytest.mark.parametrize("L", [48, 5120])
def test_normmod_unaligned_rows_match_plain(dev, L):
    """Rows that are not 16-byte aligned take one-digit runs (V 1) on the
    short and the block route: digits identical to the plain version."""
    rng = np.random.default_rng(8)
    W = 16 * L
    flat = _rand(rng, (7 * L + 1,), -(1 << 29), 1 << 29, dev)
    x = flat[1:].view(7, L)
    assert x.data_ptr() % 16
    for s in (0, 5, W + 17):
        got = _launched("normmod", lambda: fused_normmod_div(x, s, W))
        assert torch.equal(got.cpu(), normmod_rows_plain(x.cpu(), s, W)), s


def test_normmod_every_width_matches_plain(dev):
    """Every L of the short and the block route, 16-byte aligned and not:
    each layout csrc/normmod.cu chooses from L and the alignment (runs of 4
    or 1 digits, the lanes or warps a row takes) launches and gives the
    plain version's digits, a +1 ripple through every digit among them."""
    rng = np.random.default_rng(9)
    for L in range(1, NORMMOD_ROW_MAX + 1):
        W = 16 * L
        s = 37 * L % (2 * W)
        x = _rand(rng, (3, L), -(1 << 29), 1 << 29, dev)
        x[1] = 0xFFFF
        flat = torch.empty(3 * L + 1, dtype=torch.int32, device=dev)
        flat[1:] = x.reshape(-1)
        want = normmod_rows_plain(x, s, W)
        for xs in (x, flat[1:].view(3, L)):
            got = _launched("normmod", lambda: fused_normmod_div(xs, s, W))
            assert torch.equal(got, want), (L, xs.data_ptr() % 16)


def test_normmod_routes_match_kernel_limits(dev):
    """The host predicate's limits are the kernel library's."""
    assert kernels.lib().mf_normmod_short_max() == NORMMOD_SHORT_MAX
    assert kernels.lib().mf_normmod_row_max() == NORMMOD_ROW_MAX
    assert kernels.lib().mf_normmod_long_max() == NORMMOD_LONG_MAX


@pytest.mark.parametrize("kind", ["random", "ones"])
def test_normmod_long_row_2_26(dev, kind):
    """The mulmod_int 2^30 ring's final normmod: one row of 2^26 digits,
    where 2W = 2^31 passes a C int.  s = 0 (normmod) and the normmod_div
    shift 2W - 16 (above 2^31); random digits and an all-0xFFFF ripple;
    digits identical to the plain version run on the card."""
    L = 1 << 26
    W = 16 * L
    rng = np.random.default_rng(14)
    x = _rand(rng, (1, L), -(1 << 29), 1 << 29, dev) if kind == "random" else \
        torch.from_numpy(_ripple_rows(rng, 1, L, "ones")).to(dev)
    for s in (0, 2 * W - 16):
        got = _launched("normmod_long", lambda: fused_normmod_div(x, s, W))
        assert torch.equal(got, normmod_rows_plain(x, s, W)), (kind, s)
        del got
        torch.cuda.empty_cache()


def test_canonicalize_route_limits_match_kernel(dev):
    """The host's route limit and tile are the kernel library's."""
    lib = kernels.lib()
    assert lib.mf_canonicalize_row_max() == CANON_ROW_MAX
    assert lib.mf_canonicalize_tile() == CANON_TILE
    assert lib.mf_canonicalize_scratch(3, CANON_ROW_MAX) == 0
    # tiles of a row: its digits and up to 3 words of alignment offset
    tiles = -(-(CANON_ROW_MAX + 1 + 3) // CANON_TILE)
    assert lib.mf_canonicalize_scratch(3, CANON_ROW_MAX + 1) == 3 * tiles + 1


# (Bt, N, fill): "random" (with Bt > 1, row 0 a ripple from digit 0 that must
# stop at row 1), "ripple" (every row all 0xFFFF but digit 0: the carry runs
# the whole row, the look-back's worst case) or "max" (digits 2^20 - 1)
CANON_CASES = [
    (1, 1, "random"), (1, 2049, "random"), (3, 5000, "random"), (2, 1 << 16, "random"),
    (1, 2, "random"), (1, 3, "random"), (4, CANON_ROW_MAX - 1, "random"),
    (4, CANON_ROW_MAX, "random"), (4, CANON_ROW_MAX + 1, "random"),
    (1, 5169, "random"), (3, 5169, "random"), (257, 5169, "random"), (1, 6209, "random"),
    (3, 6209, "random"), (257, 6209, "random"), (257, 5169, "ripple"), (3, 6209, "ripple"),
    (1, 5 * CANON_TILE + 7, "random"), (3, 3 * CANON_TILE + 1001, "random"),
    (1, 40 * CANON_TILE + 3, "ripple"), (2, 2500002, "ripple"), (3, 9000, "max"),
    (2, 5169, "max"),
]


@pytest.mark.parametrize("Bt,N,fill", CANON_CASES)
def test_canonicalize_matches_plain(dev, Bt, N, fill):
    rng = np.random.default_rng(4)
    if fill == "max":
        x = np.full((Bt, N), (1 << 20) - 1, dtype=np.int32)
    else:
        x = rng.integers(0, 1 << 20, (Bt, N)).astype(np.int32)
    ripple = range(Bt) if fill == "ripple" else [0] if Bt > 1 else []
    for r in ripple:
        x[r] = 0xFFFF
        x[r, 0] = 0x1FFFF
    if N > 4:
        x[:, -2:] = 0
    xt = torch.from_numpy(x)
    want = canonicalize_plain_torch(xt)
    got = _launched("canonicalize", lambda: fused_canonicalize_plain(xt.to(dev)))
    assert torch.equal(got.cpu(), want)
    # one word off 16-byte alignment: the single-word runs
    flat = torch.empty(Bt * N + 1, dtype=torch.int32, device=dev)
    xs = flat[1:].view(Bt, N)
    xs.copy_(xt)
    assert torch.equal(_launched("canonicalize", lambda: fused_canonicalize_plain(xs)).cpu(), want)


def _launched(name, fn):
    before = kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1, name
    return out


@pytest.mark.parametrize("B,h,L,e0,step", [
    (6, 3, 16, 5, 7), (8, 8, 71, 0, 3), (4, 4, 64, 1, -5), (5, 5, 32, 0, 4), (3, 1, 70, 9, 0),
    (7 * 256, 256, 48, 0, 6), (7 * 256, 256, 48, 3, -5), (5 * 256, 256, 64, 1, 8),
    (3, 3, 4096, 0, -4), (3, 3, 4096, 5, 7), (2, 2, 8192, 2, -9),
])
def test_twiddle_half_matches_plain(dev, B, h, L, e0, step):
    """Raw digits identical to the plain version: even and odd exponents,
    negative steps, several rows per CTA (85 rows of L 48, a B that is no
    multiple of it), one CTA per row (L 4096) and several (L 8192)."""
    rng = np.random.default_rng(5)
    W = 16 * L
    x = _rand(rng, (B // h, h, L), -(1 << 17), 1 << 17, dev)
    got = _launched("twiddle_half", lambda: fused_twiddle_half(x, e0, step, W))
    j = torch.arange(x.numel() // L) % h
    want = twiddle_half_rows_plain(x.reshape(-1, L).cpu(), _affine_half_exps(j, e0, step, W), W)
    assert torch.equal(got.cpu(), want.reshape(x.shape))
    assert int(got.abs().max()) < 1 << 18


@pytest.mark.parametrize("fill", ["random", "ones"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("N,h,L,w", [(2, 4, 16, 1), (1, 8, 71, 3), (3, 2, 64, 157), (2, 16, 256, 1),
                                     (1, 2, 2071, 3), (1, 4, 5120, 5), (1, 6, 2048, 1),
                                     (3, 700, 64, 3), (2, 1, 100, 7), (1, 2, 8192, 5)])
def test_sqrt2_top_matches_plain(dev, N, h, L, w, offset, fill):
    """The forward layer equal to the plain version after normmod (digits in
    [-1, 2^16]); the inverse merge without a tail equal after normmod, with
    it (norm_div 5, 16, 17) canonical and identical.  L 5120, w 5 and L
    2048, w 1 are the 1.2x10^9 and 10^9-bit plans' rows; L 2071, 71 and 100
    take runs of one digit (L % 4 != 0 or, L 100, the partial last thread's
    runs of four), offset 1 a view one int off 16-byte alignment (runs of
    one); (3, 700, 64) gives a CTA many row pairs; L 8192 is the widest
    row; "ones" fills every digit with 0xFFFF."""
    rng = np.random.default_rng(6)
    W = 16 * L
    buf = torch.empty(N * 2 * h * L + offset, dtype=torch.int32, device=dev)
    x = buf[offset:].view(N, 2 * h, L)
    if fill == "ones":
        x.fill_(0xFFFF)
    else:
        x.copy_(_rand(rng, (N, 2 * h, L), -(1 << 17), 1 << 17, dev))
    got = _launched("sqrt2_top_fwd", lambda: fused_sqrt2_top_fwd(x, w, W))
    assert torch.equal(_canon(got), _canon(sqrt2_top_fwd_plain(x.cpu(), w, W)))
    assert int(got.min()) >= -1 and int(got.max()) <= 1 << 16
    for nd in (0, 5, 16, 17):
        got = _launched("sqrt2_top_inv", lambda: fused_sqrt2_top_inv(x, w, W, norm_div=nd))
        want = sqrt2_top_inv_plain(x.cpu(), w, W, norm_div=nd)
        if nd:
            assert torch.equal(got.cpu(), want)       # canonical output
        else:
            assert torch.equal(_canon(got), _canon(want))
            assert int(got.min()) >= -1 and int(got.max()) <= 1 << 16


def _ring_row(rng, value, L):
    """Digits of value mod 2^(16L)+1 (the -1 form for 2^(16L)), made
    redundant by moves of 2^16 from a digit to the one below."""
    p = (1 << (16 * L)) + 1
    value %= p
    if value == p - 1:
        d = np.zeros(L, np.int64)
        d[0] = -1
    else:
        d = np.array([(value >> (16 * i)) & 0xFFFF for i in range(L)], np.int64)
    for i in rng.integers(0, L - 1, L // 3):
        d[i] += 1 << 16
        d[i + 1] -= 1
    return d.astype(np.int32)


@pytest.mark.parametrize("nd", [5, 16, 17])
@pytest.mark.parametrize("L", [64, 100, 2048, 5120])
def test_sqrt2_top_inv_edge_rows(dev, L, nd):
    """The norm tail's carry-out folds and ripples: with oR = 0 the outputs
    are sL / 2^nd, and sL is chosen so that they are 2^W (the -1 form),
    2^W - 1 (every digit 0xFFFF), 0, 1 and values whose low digits ripple."""
    rng = np.random.default_rng(8)
    W = 16 * L
    p = (1 << W) + 1
    targets = [p - 1, p - 2, 0, 1, (1 << (W - 16)) - 1, p - (1 << 40), 1 << (W - 1)]
    h = len(targets)
    x = np.zeros((1, 2 * h, L), np.int32)
    for j, t in enumerate(targets):
        x[0, j] = _ring_row(rng, t * pow(2, nd, p), L)
    x = torch.from_numpy(x).to(dev)
    got = _launched("sqrt2_top_inv", lambda: fused_sqrt2_top_inv(x, 1, W, norm_div=nd))
    want = sqrt2_top_inv_plain(x.cpu(), 1, W, norm_div=nd)
    assert torch.equal(got.cpu(), want)
    assert int(want[0, 0, 0]) == -1 and bool((want[0, 1] == 0xFFFF).all())


@pytest.mark.parametrize("half", [None, (0, 1), (5, -3)])
@pytest.mark.parametrize("kind", ["fwd", "inv"])
@pytest.mark.parametrize("B,C,L,w", [
    (3, 32, 16, 1), (5, 256, 32, 4), (2, 128, 72, 18), (4, 64, 84, 42), (3, 8, 71, 3),
    (7, 256, 48, 6), (5, 256, 64, 8), (3, 2, 8192, 5),
])
def test_transform_small_matches_plain(dev, kind, B, C, L, w, half):
    """Raw digits identical to the plain version, without and with the
    half-bit option (pre_half forward, post_half inverse; the exponents
    (e0, step * w), odd ones at e0 5)."""
    rng = np.random.default_rng(7)
    W = 16 * L
    x = _rand(rng, (B, C, L), -(1 << 17), 1 << 17, dev)
    opt = None if half is None else (half[0], half[1] * w)
    pre, post = (opt, None) if kind == "fwd" else (None, opt)
    name = "transform_small" if half is None else "transform_small_half"
    got = _launched(name, lambda: fused_transform(kind, x, w, W, pre, post))
    want = transform_plain(kind, x.cpu(), w, W, pre, post)
    assert torch.equal(got.cpu(), want)
    assert int(got.abs().max()) < 1 << 17


@pytest.mark.parametrize("bits_a,bits_b", [(12000, 12000), (16000, 16000), (12000, 5000),
                                           (48000, 48000), (40000, 40000), (40000, 17000)])
def test_mul_exact_on_gpu(dev, bits_a, bits_b):
    rnd = random.Random(bits_a + bits_b)
    a = rnd.getrandbits(bits_a) | (1 << (bits_a - 1))
    b = rnd.getrandbits(bits_b) | (1 << (bits_b - 1))
    assert mul(a, b, device=dev) == a * b
    assert sqr(a, device=dev) == a * a


@pytest.mark.parametrize("bits,depth", [(150000, 2), (530000, 4)])
def test_recursive_pointwise_on_gpu(dev, bits, depth):
    """L 2344 (even w) and L 2071 (odd w): the pointwise recurses."""
    plan = plan_for_depth(bits, bits, depth, sqrt2=True)
    rnd = random.Random(bits)
    a = rnd.getrandbits(bits) | (1 << (bits - 1))
    b = rnd.getrandbits(bits) | (1 << (bits - 1))
    da = torch.from_numpy(digits_from_int(a, -(-bits // 16))).to(dev)
    db = torch.from_numpy(digits_from_int(b, -(-bits // 16))).to(dev)
    kernels.reset_launches()
    got = int_from_digits(mpn_mul_flagship(da, db, plan).cpu().numpy())
    assert got == a * b
    # the inner rings' weights ride the whole-row transform: no twiddle pass
    assert kernels.LAUNCHES["transform_small_half"] == 3 and kernels.LAUNCHES["twiddle_half"] == 0


@pytest.mark.parametrize("N", [1 << 15, 37504, 49152])
def test_mulmod_int_on_gpu(dev, N):
    p = (1 << N) + 1
    rnd = random.Random(N)
    a, b = rnd.getrandbits(N), rnd.getrandbits(N)
    assert mulmod_int(a, b, N, device=dev) == a * b % p
    for x, y in ((p - 1, p - 1), (p - 1, b), (0, b), ((1 << N) - 1, a)):
        assert mulmod_int(x, y, N, device=dev) == x * y % p


@pytest.mark.parametrize("B", [17, 4096])
@pytest.mark.parametrize("M", [4, 128, 2048])
def test_ntt_links_match_plain(dev, B, M):
    """input_planes, mid_planes and garner_carry against their plain
    versions, each on the previous link's real output: identical."""
    rng = np.random.default_rng(8)
    x = _rand(rng, (B, M), -(1 << 25), 1 << 25, dev)
    y = _rand(rng, (B, M), -(1 << 25), 1 << 25, dev)
    pa = _launched("input_planes", lambda: input_planes(x))
    pb = input_planes(y)
    assert torch.equal(pa.cpu(), input_planes_plain(x.cpu()))
    parts = []
    for j, (p, F, G) in enumerate(_blocks(M, dev)):
        sa, sb = _dot_raw(pa[j], F), _dot_raw(pb[j], F)
        assert torch.equal(sa, (pa[j].double() @ F.double()).int())    # exact: sums < 2^27
        pp = _launched("mid_planes", lambda: mid_planes(sa, sb, p))
        assert torch.equal(pp.cpu(), mid_planes_plain(sa.cpu(), sb.cpu(), p))
        parts.append(_dot_raw(pp, G))
    d = _launched("garner_carry", lambda: garner_carry(*parts))
    assert torch.equal(d.cpu(), garner_carry_plain(*(s.cpu() for s in parts)))
    assert int(d.abs().max()) < (1 << 16) + (1 << 12)
    if B == 17:
        want = mulmod_ntt(x.cpu(), y.cpu(), canonical=True)
        assert torch.equal(mulmod_ntt(x, y, canonical=True).cpu(), want)


def test_mul_default_ntt_plan_on_gpu(dev):
    """A default plan whose pointwise is the dense NTT: the three links and
    the GEMMs launch, the schoolbook does not."""
    bits = 120000
    assert choose_params(bits, bits, sqrt2=True).W // 16 == 64
    rnd = random.Random(bits)
    a, b = rnd.getrandbits(bits) | (1 << (bits - 1)), rnd.getrandbits(bits)
    kernels.reset_launches()
    assert mul(a, b, device=dev) == a * b
    assert sqr(a, device=dev) == a * a
    got = dict(kernels.LAUNCHES)
    for name in ("input_planes", "mid_planes", "garner_carry", "int8_gemm"):
        assert got[name] > 0, name
    assert got["conv_base"] == 0
    assert got["int8_gemm"] == 9 + 6          # mul: 2 x 3 forward + 3 inverse; sqr: 3 + 3


def test_ntt_wrappers_reject(dev):
    x = torch.zeros((32, 64), dtype=torch.int32, device=dev)
    s = torch.zeros((32, 128), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        input_planes(x.to(torch.int64))
    with pytest.raises(ValueError):
        input_planes(torch.zeros((32, 128), dtype=torch.int32, device=dev)[:, ::2])
    with pytest.raises(ValueError):
        input_planes(x.view(-1)[1:1 + 31 * 64].view(31, 64))     # rows not 16-byte aligned
    with pytest.raises(TypeError):
        mid_planes(s.to(torch.int8), s, PRIMES[0])
    with pytest.raises(ValueError):
        mid_planes(s, s[:, ::2].contiguous(), PRIMES[0])
    with pytest.raises(ValueError):
        mid_planes(s.t(), s.t(), PRIMES[0])
    with pytest.raises(ValueError):
        garner_carry(s, s, s[:16])
    with pytest.raises(TypeError):
        garner_carry(s, s.float(), s)


@pytest.mark.parametrize("B", [17, 4096])
@pytest.mark.parametrize("M", [4096, 8192])
def test_ntt4_links_match_plain(dev, B, M):
    """The 4-step tier's links and Garner's residue form against their
    plain versions (run on the same card), each on the previous link's
    real output: identical."""
    rng = np.random.default_rng(9)
    x = _rand(rng, (B, M), -(1 << 25), 1 << 25, dev)
    y = _rand(rng, (B, M), -(1 << 25), 1 << 25, dev)
    pa = _launched("ntt4_input_planes", lambda: ntt4_input_planes(x))
    pb = ntt4_input_planes(y)
    assert torch.equal(pa, ntt4_input_planes_plain(x))
    res = []
    for j, blk in enumerate(_ntt4_blocks(M, dev)):
        p = blk.p
        S1 = _dot_raw(pa[j], blk.F1)
        assert torch.equal(S1, (pa[j].double() @ blk.F1.double()).int())    # exact: sums < 2^23
        pl2 = _launched("ntt4_fwd_twiddle", lambda: ntt4_fwd_twiddle(S1, p, M))
        assert torch.equal(pl2, ntt4_fwd_twiddle_plain(S1, p, M))
        Sa = _dot_raw(pl2, blk.F2)
        Sb = _dot_raw(ntt4_fwd_twiddle(_dot_raw(pb[j], blk.F1), p, M), blk.F2)
        pp = _launched("ntt4_pointwise", lambda: ntt4_pointwise(Sa, Sb, p, M))
        assert torch.equal(pp, ntt4_pointwise_plain(Sa, Sb, p, M))
        assert torch.equal(ntt4_pointwise(Sa, Sa, p, M), ntt4_pointwise_plain(Sa, Sa, p, M))
        S3 = _dot_raw(pp, blk.G2)
        pl4 = _launched("ntt4_inv_twiddle", lambda: ntt4_inv_twiddle(S3, p, M))
        assert torch.equal(pl4, ntt4_inv_twiddle_plain(S3, p, M))
        S4 = _dot_raw(pl4, blk.G1)
        r = _launched("ntt4_residues", lambda: ntt4_residues(S4, p, M))
        assert torch.equal(r, ntt4_residues_plain(S4, p, M))
        res.append(r)
    d = _launched("garner_residues", lambda: garner_residues(*res))
    assert torch.equal(d, garner_residues_plain(*res))
    assert int(d.abs().max()) < (1 << 16) + (1 << 12)
    if B == 17:
        want = mulmod_ntt(x.cpu(), y.cpu(), canonical=True)
        assert torch.equal(mulmod_ntt(x, y, canonical=True).cpu(), want)


@pytest.mark.parametrize("B", [17, 1024])
@pytest.mark.parametrize("M", [4096, 8192])
def test_ntt4_fused_matches_plain(dev, B, M):
    """The fused kernel's three residue rows against its plain version, a
    product and a square."""
    rng = np.random.default_rng(10)
    x = _rand(rng, (B, M), -(1 << 25), 1 << 25, dev)
    y = _rand(rng, (B, M), -(1 << 25), 1 << 25, dev)
    got = _launched("ntt4_fused", lambda: ntt4_fused(x, y))
    assert torch.equal(got, ntt4_fused_plain(x, y))
    assert torch.equal(ntt4_fused(x, x), ntt4_fused_plain(x, x))


def test_ntt4_wrappers_reject(dev):
    x = torch.zeros((32, 4096), dtype=torch.int32, device=dev)
    S = torch.zeros((32 * 64, 192), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        ntt4_input_planes(x.to(torch.int64))
    with pytest.raises(ValueError):
        ntt4_input_planes(x.view(-1)[1:1 + 31 * 4096].view(31, 4096))     # rows not 16-byte aligned
    with pytest.raises(ValueError):
        ntt4_fwd_twiddle(S, PRIMES[0], 4096)
    with pytest.raises(ValueError):
        ntt4_fwd_twiddle(S.t(), PRIMES_T2[0], 4096)
    with pytest.raises(ValueError):
        ntt4_pointwise(S, S[:64], PRIMES_T2[0], 4096)
    with pytest.raises(ValueError):
        ntt4_residues(S[:, :96].contiguous(), PRIMES_T2[0], 4096)
    with pytest.raises(ValueError):
        garner_residues(x, x, x[:16])
    with pytest.raises(ValueError):
        ntt4_fused(x, x.cpu())


@pytest.mark.parametrize("bits,L", [(524200, 4096), (1048500, 8192)])
def test_mul_tier2_plans_on_gpu(dev, bits, L):
    """plan_for_depth(bits, bits, 3) (L 4096, L 8192; conv 32): exact, the
    pointwise on the 4-step tier (18 GEMMs for a product, 12 for a square),
    nothing recursive."""
    plan = plan_for_depth(bits, bits, 3, sqrt2=True)
    assert plan.W // 16 == L
    rnd = random.Random(bits)
    a = rnd.getrandbits(bits) | (1 << (bits - 1))
    b = rnd.getrandbits(bits) | (1 << (bits - 1))
    da = torch.from_numpy(digits_from_int(a, -(-bits // 16))).to(dev)
    db = torch.from_numpy(digits_from_int(b, -(-bits // 16))).to(dev)
    kernels.reset_launches()
    assert int_from_digits(mpn_mul_flagship(da, db, plan).cpu().numpy()) == a * b
    got = dict(kernels.LAUNCHES)
    for name in ("ntt4_input_planes", "ntt4_fwd_twiddle", "ntt4_pointwise", "ntt4_inv_twiddle",
                 "ntt4_residues", "garner_residues"):
        assert got[name] > 0, name
    assert got["int8_gemm"] == 18
    for name in ("transform_small", "transform_small_half", "twiddle_half", "conv_base",
                 "input_planes", "ntt4_fused"):
        assert got[name] == 0, name
    kernels.reset_launches()
    assert int_from_digits(mpn_sqr_flagship(da, plan).cpu().numpy()) == a * a
    assert kernels.LAUNCHES["int8_gemm"] == 12 and kernels.LAUNCHES["ntt4_input_planes"] == 1


def test_mulmod_int_fused_on_gpu(dev, monkeypatch):
    """MPIR_FFT_NTT_FUSED=1: the L 4096 ring of N = 65536 through the fused
    kernel, exact."""
    monkeypatch.setenv("MPIR_FFT_NTT_FUSED", "1")
    N = 65536
    p = (1 << N) + 1
    rnd = random.Random(N)
    a, b = rnd.getrandbits(N), rnd.getrandbits(N)
    kernels.reset_launches()
    for x, y in ((a, b), (p - 1, p - 1), ((1 << N) - 1, a)):
        assert mulmod_int(x, y, N, device=dev) == x * y % p
    assert kernels.LAUNCHES["ntt4_fused"] == 3 and kernels.LAUNCHES["ntt4_input_planes"] == 0


@pytest.mark.parametrize("kind", ["fwd", "inv"])
@pytest.mark.parametrize("B,n1,n2,L,w", [(2 * 64, 64, 128, 256, 1), (2 * 16, 16, 32, 16, 3),
                                         (2 * 128, 128, 128, 512, 1), (128, 128, 128, 1024, 2),
                                         (16, 16, 256, 1024, 1)])
def test_mfa_cols_matches_plain(dev, kind, B, n1, n2, L, w):
    """The column kernel in both flavours, full and truncated at trunc2 in
    {1, n2/2, n2/2 + 1, n2 - 1}, against its plain version (the truncate.py
    recursion on the host): identical raw digits.  One CTA a column at
    (128, 256) and (32, 16); clusters of 2, 4 and 8 at (128, 512), (128,
    1024) and (256, 1024) (whose full column the reference does not fuse).
    B spans two copies of the column axis (the stacked operands) where
    B = 2 n1."""
    rng = np.random.default_rng(11)
    W = 16 * L
    x = _rand(rng, (B, n2, L), -(1 << 17), 1 << 17, dev)
    for trunc2 in (1, n2 // 2, n2 // 2 + 1, n2 - 1, n2):
        if not mfa_col_fits(n2, L, trunc2 == n2):
            assert (n2, L, trunc2) == (256, 1024, 256)
            continue
        for one in (False, True):
            xin = x
            if kind == "fwd" and not one:       # fft_trunc: zero input tail
                xin = x.clone()
                xin[:, trunc2:] = 0
            got = _launched("mfa_cols", lambda: fused_mfa_cols(kind, xin, w, W, n1, trunc2, one))
            want = mfa_cols_plain(kind, xin.cpu(), w, W, n1, trunc2, one)
            assert torch.equal(got.cpu(), want), (trunc2, one)


def test_mfa_cols_rejects(dev):
    x = torch.zeros((8, 4, 16), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):          # a full column past the reference's 512 KB
        fused_mfa_cols("fwd", torch.zeros((2, 256, 1024), dtype=torch.int32, device=dev),
                       1, 16 * 1024, 2, 256)
    with pytest.raises(ValueError):          # L 2048: the ladder route in both packages
        fused_mfa_cols("fwd", torch.zeros((2, 4, 2048), dtype=torch.int32, device=dev),
                       1, 16 * 2048, 2, 2)
    with pytest.raises(ValueError):          # truncated, 4 MB: no cluster of 8 holds it
        fused_mfa_cols("fwd", torch.zeros((1, 1024, 1024), dtype=torch.int32, device=dev),
                       1, 16 * 1024, 1, 600)
    with pytest.raises(ValueError):          # zero-size batch
        fused_mfa_cols("fwd", x[:0], 1, 256, 4, 4)
    with pytest.raises(TypeError):
        fused_mfa_cols("fwd", x.to(torch.int64), 1, 256, 4, 4)
    with pytest.raises(ValueError):          # B not a multiple of n1
        fused_mfa_cols("fwd", x[:6], 1, 256, 4, 4)
    with pytest.raises(ValueError):
        fused_mfa_cols("fwd", x, 1, 256, 4, 5)


@pytest.mark.parametrize("kind", ["fwd", "inv"])
@pytest.mark.parametrize("N,K,L,step", [(6, 8, 16, 3), (4, 4, 71, 12), (8, 8, 2048, 1),
                                        (4, 0, 1024, 1), (3, 0, 2048, 5), (2, 0, 3072, 24),
                                        (2, 0, 4096, 2)])
def test_ladder_pe_matches_plain(dev, kind, N, K, L, step):
    """The ladder with its last-stage table against ladder_plain: raw digits
    identical; launches count under ladder_pe."""
    rng = np.random.default_rng(12)
    K = _main_K(K, L)
    W = 16 * L
    k = K.bit_length() - 1
    steps = tuple(step << j for j in range(k))
    x = _rand(rng, (N, K, 1, L), -(1 << 17), 1 << 17, dev)
    pe = _rand(rng, (N, K // 2, 2), 0, 2 * W, dev)
    got = _launched("ladder_pe", lambda: fused_butterfly_ladder(kind, x, steps, W, pe))
    assert torch.equal(got.cpu(), ladder_plain(kind, x.cpu(), steps, W, pe.cpu()))
    with pytest.raises(ValueError):           # a table needs h == 1
        fused_butterfly_ladder(kind, x.reshape(N, K // 2, 2, L), steps[1:], W, pe)


# (driver, plan): the CPU test plans, truncated ones included
DRIVER_PLANS = [
    ("radix2", plan_for_depth(6000, 6000, 3, False)),
    ("sqrt2", plan_for_depth(6000, 6000, 3, True)),
    ("trunc", plan_for_depth(40000, 12000, 8, False)),
    ("trunc_sqrt2", plan_for_depth(12000, 4000, 3, True)),
    ("mfa", plan_for_depth(6000, 6000, 3, False)),
    ("mfa_trunc", validate(MulPlan(6, 2, 32, 50, 10, 1600, 320, False))),
    ("flagship", plan_for_depth(40000, 12000, 8, True)),
    ("flagship", plan_for_depth(30000, 6000, 8, True)),
    ("flagship", validate(MulPlan(6, 2, 32, 120, 16, 3840, 512, True))),
]


@pytest.mark.parametrize("kind,plan", DRIVER_PLANS)
def test_drivers_exact_on_gpu(dev, kind, plan):
    rnd = random.Random(plan.bits_a + plan.bits_b)
    a = rnd.getrandbits(plan.bits_a) | (1 << (plan.bits_a - 1))
    b = rnd.getrandbits(plan.bits_b) | (1 << (plan.bits_b - 1))
    da = torch.from_numpy(digits_from_int(a, -(-plan.bits_a // 16))).to(dev)
    db = torch.from_numpy(digits_from_int(b, -(-plan.bits_b // 16))).to(dev)
    kernels.reset_launches()
    assert int_from_digits(DRIVERS[kind][0](da, db, plan).cpu().numpy()) == a * b
    if kind.startswith("mfa") or (kind == "flagship" and plan.trunc_mfa < plan.conv_len):
        assert kernels.LAUNCHES["mfa_cols"] + kernels.LAUNCHES["ladder_pe"] > 0


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_mul_driver_on_gpu(dev, driver):
    rnd = random.Random(7)
    a, b = rnd.getrandbits(60000) | (1 << 59999), rnd.getrandbits(17000)
    assert mul(a, b, driver=driver, device=dev) == a * b


# ---------------------------------------------------------------------------
# the staged flagship's kernel pieces: the ladder's pre_half, Garner's post leg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,K,h,L,e0,step2", [
    (2, 16, 8, 32, 0, 1), (3, 4, 5, 71, 9, 7), (1, 8, 16, 2048, 0, 1), (2, 2, 1, 16, 3, 5),
    (1, 0, 8, 1024, 0, 2), (1, 0, 4, 2048, 0, 1), (1, 0, 4, 3072, 5, 24), (1, 0, 4, 4096, 0, 2),
    (2, 0, 3, 72, 1, 7),
])
def test_ladder_pre_half_matches_plain(dev, N, K, h, L, e0, step2):
    """The ladder with its pre_half twiddle (a transform's first group, each
    batch row one transform) against ladder_plain: raw digits identical;
    launches count under ladder_pre_half."""
    rng = np.random.default_rng(13)
    K = _main_K(K, L)
    W = 16 * L
    k = K.bit_length() - 1
    steps = tuple(step2 << j for j in range(k))
    x = _rand(rng, (N, K, h, L), -(1 << 17), 1 << 17, dev)
    got = _launched("ladder_pre_half",
                    lambda: fused_butterfly_ladder("fwd", x, steps, W, pre_half=(e0, step2)))
    assert torch.equal(got.cpu(), ladder_plain("fwd", x.cpu(), steps, W, pre_half=(e0, step2)))


@pytest.mark.parametrize("M,B", [(128, 64), (1024, 48), (2048, 24), (4096, 12), (8192, 4),
                                 (4, 32), (8, 48), (1024, 160), (2048, 64), (4096, 32)])
def test_garner_post_matches_plain(dev, M, B):
    """Both Garner forms with the post leg (K = 2^ladder_stages(M) rows per
    CTA) against the plain Garner then ifft_innermost_body: raw digits
    identical; launches count under garner_carry_post / garner_residues_post."""
    rng = np.random.default_rng(14)
    W = 16 * M
    kg = ladder_stages(M)
    K = 1 << kg
    steps = tuple(W >> (kg - j) for j in range(kg))
    if M <= 2048:
        lim = 2 * M * 128 * 128
        parts = [_rand(rng, (B, 2 * M), -lim, lim + 1, dev) for _ in range(3)]
        got = _launched("garner_carry_post", lambda: garner_carry(*parts, post=(K, steps)))
        want = garner_carry_plain(*(s.cpu() for s in parts))
    else:
        parts = [_rand(rng, (B, M), 0, p, dev) for p in PRIMES_T2]
        got = _launched("garner_residues_post", lambda: garner_residues(*parts, post=(K, steps)))
        want = garner_residues_plain(*(r.cpu() for r in parts))
    assert torch.equal(got.cpu(), ifft_innermost_body(want, steps, W, K))


def test_staged_equals_unstaged_at_1e8(dev):
    """The 10^8-bit default plan is staged: mul() and sqr() take
    _staged_flagship, launch the new pieces (the zero-top t-leg's
    ladder_pre_half, the Garner post leg) and not the top layer, and the
    staged digits equal mpn_mul_flagship's."""
    bits = 100_000_000
    plan = choose_params(bits, bits, sqrt2=True)
    assert flagship_is_staged(plan)
    rnd = random.Random(bits)
    a, b = rnd.getrandbits(bits) | (1 << (bits - 1)), rnd.getrandbits(bits) | (1 << (bits - 1))
    da = torch.from_numpy(digits_from_int(a, -(-bits // 16))).to(dev)
    db = torch.from_numpy(digits_from_int(b, -(-bits // 16))).to(dev)
    kernels.reset_launches()
    got = _staged_flagship(plan)(da, db)
    assert kernels.LAUNCHES["ladder_pre_half"] > 0 and kernels.LAUNCHES["garner_carry_post"] > 0
    assert kernels.LAUNCHES["sqrt2_top_fwd"] == 0
    assert torch.equal(got, mpn_mul_flagship(da, db, plan))
    assert torch.equal(_staged_flagship(plan)(da), mpn_sqr_flagship(da, plan))
    p = (1 << 61) - 1
    assert mul(a, b, device=dev) % p == (a % p) * (b % p) % p


@pytest.mark.parametrize("bits,depth", [(100_000, 7), (150_000, 7)])
def test_mul_huge_passes_match_plain(dev, bits, depth):
    """The out-of-core engine with 64 KB chunks (several a pass) on the card
    against the same engine on the host, which runs every kernel's plain
    version: each pass's packed output identical (canonical digits), the
    product equal to the staged flagship's and to Python's (odd w with
    trunc_mfa > h, and even w)."""
    plan = plan_for_depth(bits, bits, depth, sqrt2=True)
    assert huge.huge_serves(plan)
    rnd = random.Random(bits)
    a, b = (rnd.getrandbits(bits) | (1 << (bits - 1)) for _ in range(2))
    da, db = (torch.from_numpy(digits_from_int(v, -(-bits // 16))) for v in (a, b))
    results = {}
    for where in (dev, torch.device("cpu")):
        x, y = da.to(where), db.to(where)
        if where.type == "cuda":
            kernels.reset_launches()
        results[where.type] = huge_passes(
            lambda: (huge.mul_huge(x, y, plan), huge.sqr_huge(x, plan)), 64 << 10)
        if where.type == "cuda":
            assert kernels.LAUNCHES["ladder_pe"] > 0 and kernels.LAUNCHES["normmod"] > 0
            assert kernels.LAUNCHES["canonicalize"] == 2
    (got, got_sq), passes = results["cuda"]
    (want, want_sq), plain = results["cpu"]
    assert len(passes) == len(plain) > 8
    for (name, rows), (pname, prows) in zip(passes, plain):
        assert name == pname and len(rows) == len(prows), name
        assert all(torch.equal(r, q) for r, q in zip(rows, prows)), name
    assert torch.equal(got.cpu(), want) and torch.equal(got_sq.cpu(), want_sq)
    assert torch.equal(got, _staged_flagship(plan)(da.to(dev), db.to(dev)))
    assert int_from_digits(got.cpu().numpy()) == a * b
    assert int_from_digits(got_sq.cpu().numpy()) == a * a


def test_mul_piecewise_on_gpu(dev, monkeypatch):
    """An extreme-uneven product as balanced pieces on the card (the
    threshold lowered below its plan): exact."""
    from mpir_fft_tpu_torch.models import mul as tmul

    rnd = random.Random(20000)
    a, b = rnd.getrandbits(20000) | (1 << 19999), rnd.getrandbits(9000) | (1 << 8999)
    plan = choose_params(20000, 9000, sqrt2=True)
    monkeypatch.setattr(tmul, "_HUGE_THRESHOLD_ELEMS", plan.conv_len * (plan.W // 16) - 1)
    assert tmul._piecewise_serves(plan)
    assert mul(a, b, device=dev) == a * b


def test_mul_many_matches_loop_on_gpu(dev):
    """mul_many: one batched driver call on the card, equal to a loop of
    mul and to Python, mixed sizes zero-padded into one plan."""
    rnd = random.Random(77)
    pairs = [(rnd.getrandbits(bits_a) | 1, rnd.getrandbits(bits_b) | 1)
             for bits_a, bits_b in ((170000, 150000), (90000, 150000), (170000, 40000),
                                    (123450, 67890))]
    kernels.reset_launches()
    got = mul_many(pairs, device=dev)
    assert kernels.LAUNCHES["canonicalize"] == 1
    assert got == [mul(a, b, device=dev) for a, b in pairs] == [a * b for a, b in pairs]


def test_tune_writes_card_entry_and_mul_through_it(dev, tmp_path, monkeypatch):
    """tune at 10^6 bits on the card: every candidate checked against the
    analytic product and timed, the entry kept under the card's name, and
    mul() through the cached plan exact."""
    import json

    from mpir_fft_tpu_torch.models import mul as tmul
    from mpir_fft_tpu_torch.utils import tune

    cache = tmp_path / "tune.json"
    monkeypatch.setenv("MPIR_FFT_TUNE_CACHE", str(cache))
    monkeypatch.delenv("MPIR_FFT_TUNE", raising=False)
    bits = 10**6
    entry = tune.tune(bits, bits, "flagship", reps=3, device=dev)
    name = torch.cuda.get_device_name(dev)
    assert entry["device"] == name
    assert json.loads(cache.read_text())[name][tune._key("flagship", bits, bits)] == entry
    assert all(len(c) == 4 and c[2] > 0 for c in entry["candidates"]), entry
    assert tmul._select_plan(bits, bits, "flagship", dev).depth == entry["depth"]
    rnd = random.Random(bits)
    a, b = rnd.getrandbits(bits) | 1 << (bits - 1), rnd.getrandbits(bits) | 1 << (bits - 1)
    assert mul(a, b, device=dev) == a * b


def test_cli_mul_file_round_trip_1e7(dev, tmp_path, monkeypatch, capsys):
    """cli mul through files at 10^7 bits on the card: the product file
    equals GMP's (or Python's) product, 2 bytes a digit of the plan."""
    from mpir_fft_tpu_torch import cli, native
    from mpir_fft_tpu_torch.models.mul import out_len_digits

    monkeypatch.setenv("MPIR_FFT_TUNE", "0")
    rnd = random.Random(10**7)
    a, b = rnd.getrandbits(10**7), rnd.getrandbits(10**7 - 12345)
    ab, bb = a.to_bytes(1250000, "little"), b.to_bytes(1248457, "little")
    (tmp_path / "a.bin").write_bytes(ab)
    (tmp_path / "b.bin").write_bytes(bb)
    out = tmp_path / "out.bin"
    assert cli.main(["mul", str(tmp_path / "a.bin"), str(tmp_path / "b.bin"), str(out)]) == 0
    got = out.read_bytes()
    plan = choose_params(8 * len(ab), 8 * len(bb), sqrt2=True)
    assert len(got) == 2 * out_len_digits(plan)
    want = native.gmp_mul(ab, bb)
    if want is None:
        want = (a * b).to_bytes(len(ab) + len(bb), "little")
    assert got == want + bytes(len(got) - len(want))


def test_profile_stages_1e7(dev, monkeypatch):
    """The stage profile at 10^7 bits on the card: every stage takes time,
    the composed stages give the route's product (checked inside), and
    the stages sum to within 0.5-2x of the whole route."""
    from mpir_fft_tpu_torch.utils.profile import profile_stages

    monkeypatch.setenv("MPIR_FFT_TUNE", "0")
    r = profile_stages(10**7, reps=3, driver="flagship", device=dev)
    stages = [k for k in r if k.endswith("_s") and k not in ("total_s", "route_s")]
    assert set(stages) == {"fwd_a_s", "fwd_b_s", "pointwise_s", "inverse_s", "combine_s"}
    assert all(r[k] > 0 for k in stages) and r["clock"] == "cuda events"
    assert 0.5 < r["stages_over_route"] < 2.0, r
    assert r["pointwise_gemm_ops"] > 0 and r["fwd_ladder_bytes"] > 0
