"""The port's sharding (parallel/mfa_sharded.py, the ctx paths of ops/mfa.py,
models/mul.py and models/huge.py) on CPU ranks joined by gloo, against
Python's products and the JAX package's sharded drivers on the conftest's 8
virtual devices.

Each world size (1, 2, 4) spawns its ranks once and runs every case there
(torch_sharded_cases.py); every rank must return the same whole result.
Spectra are compared mod p after normmod at the kept positions; products
digit for digit.  All arithmetic is integer, so the tolerance is exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_sharded_cases as cases
from mpir_fft_tpu.ops.limb import digits_from_int as jdigits_from_int
from mpir_fft_tpu.ops.mfa import mfa_fft_trunc_sqrt2 as jfft_trunc_sqrt2
from mpir_fft_tpu.ops.split import fft_split_bits as jsplit
from mpir_fft_tpu.parallel.mfa_sharded import ShardCtx as JShardCtx
from mpir_fft_tpu.parallel.mfa_sharded import sharded_mul_fn as jsharded_mul_fn
from mpir_fft_tpu.utils.params import MulPlan as JMulPlan
from mpir_fft_tpu_torch.models.mul import out_len_digits
from mpir_fft_tpu_torch.ops import fused as tfused
from mpir_fft_tpu_torch.ops import mfa as tmfa
from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, normmod
from mpir_fft_tpu_torch.ops.ntt import garner_post, mulmod_ntt
from mpir_fft_tpu_torch.parallel import dryrun
from mpir_fft_tpu_torch.parallel import mfa_sharded as S
from mpir_fft_tpu_torch.utils.params import MulPlan, cdiv, plan_for_depth, validate

WORLDS = [1, 2, 4]
TIMEOUT = 300.0

# the drivers the reference shards, at its steps' 8-device plan (depth 6)
DRIVERS = ["flagship", "mfa", "mfa_trunc"]
# sqrt2 spectra: (bits_a, bits_b, depth) -> odd w full length, even w full,
# odd w truncated at trunc <= h, odd w truncated past h with one kept row
SPECTRA = {"odd-full": (1 << 14, 1 << 14, 5), "even-full": (5000, 1000, 5),
           "odd-t<=h": (5000, 1000, 7), "odd-t>h": (40000, 10000, 8)}
# uneven products: the reference's test_sharded_flagship_uneven_operands,
# a truncated MFA with 7 kept rows, the truncated sqrt2 plans above
UNEVEN = {"flagship-3x2^13x9000": ("flagship", (3 << 13, 9000, 6, True)),
          "mfa_trunc-3000x500": ("mfa_trunc", (3000, 500, 7, False)),
          "flagship-5000x1000": ("flagship", (5000, 1000, 7, True)),
          "flagship-40000x10000": ("flagship", (40000, 10000, 8, True))}
# the reference's hand-built staged plan (tests/test_mfa.py:241): L 128,
# n1 8, trunc_mfa 128 -- the Garner hook K = n1 fits and must be taken
GARNER = MulPlan(6, 32, 992, 64, 64, 64 * 992, 64 * 992, True)
# out of core: (bits_a, bits_b, depth) or a hand-built plan, and square
OUT_OF_CORE = {"odd-t>h": ((1 << 15, 1 << 15, 6, True), False),
               "even": ((50_000, 50_000, 5, True), False),
               "odd-t<=h": (MulPlan(6, 7, 160, 63, 63, 10_000, 10_000, True), False),
               "sqr": ((1 << 15, 1 << 15, 6, True), True),
               "unsharded-k2=1": ((40000, 10000, 8, True), False)}


def _operand(rng, bits):
    return int.from_bytes(rng.bytes(bits // 8), "little") | 1


def _plan(spec):
    """A hand-built plan, or plan_for_depth(bits_a, bits_b, depth, sqrt2)."""
    return spec if isinstance(spec, MulPlan) else plan_for_depth(*spec)


def _fields(plan):
    return dataclasses.asdict(validate(plan))


def _operands():
    """Every seeded operand the cases take: one numpy seed, passed to every
    rank alike."""
    rng = np.random.default_rng(18)
    ops = {}
    for kind in DRIVERS:
        plan = plan_for_depth(1 << 14, 1 << 14, 6, sqrt2=kind == "flagship")
        ops[kind] = (plan, _operand(rng, 1 << 14), _operand(rng, 1 << 14))
    for name, (ba, bb, d) in SPECTRA.items():
        ops["spectrum " + name] = (plan_for_depth(ba, bb, d, sqrt2=True), _operand(rng, ba), None)
    for name, (kind, spec) in UNEVEN.items():
        plan = _plan(spec)
        ops["uneven " + name] = (plan, _operand(rng, plan.bits_a), _operand(rng, plan.bits_b))
    ops["garner"] = (GARNER, _operand(rng, GARNER.bits_a), _operand(rng, GARNER.bits_b))
    ops["staged"] = (plan_for_depth(1 << 14, 1 << 14, 6, sqrt2=True), _operand(rng, 1 << 14),
                     _operand(rng, 1 << 14))
    for name, (spec, _) in OUT_OF_CORE.items():
        plan = _plan(spec)
        ops["ooc " + name] = (plan, _operand(rng, plan.bits_a), _operand(rng, plan.bits_b))
    return ops


OPS = _operands()


def _case_list():
    out = []
    for kind in DRIVERS:
        plan, a, b = OPS[kind]
        out.append((kind, cases.product, (kind, _fields(plan), a, b)))
    for name in SPECTRA:
        plan, a, _ = OPS["spectrum " + name]
        digits = jdigits_from_int(a, cdiv(plan.bits_a, DIGIT_BITS))
        out.append(("spectrum " + name, cases.spectrum, (digits, _fields(plan), plan.trunc_mfa)))
    for name, (kind, _) in UNEVEN.items():
        plan, a, b = OPS["uneven " + name]
        out.append(("uneven " + name, cases.product, (kind, _fields(plan), a, b)))
    plan, a, b = OPS["staged"]
    out.append(("staged", cases.product, ("staged", _fields(plan), a, b)))
    plan, a, b = OPS["garner"]
    out.append(("garner", cases.garner, (_fields(plan), a, b)))
    out.append(("exchanges", cases.exchanges, (_fields(plan), a, b)))
    out.append(("dp", S.sharded_mul_many_step, ()))
    out.append(("dp uneven", cases.dp_uneven, ()))
    for name, (_, square) in OUT_OF_CORE.items():
        plan, a, b = OPS["ooc " + name]
        out.append(("ooc " + name, cases.out_of_core, (_fields(plan), a, b, square)))
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"ranks{n}")
def ranks(request):
    """(world size, every rank's {case: result}), one spawn per size."""
    n = request.param
    return n, dryrun.run_ranks(n, cases.run, (_case_list(),), device="cpu", backend="gloo",
                               timeout=TIMEOUT)


def _whole(ranks, name):
    """The result of case name, the same on every rank."""
    n, res = ranks
    first = res[0][name]
    for r in res[1:]:
        assert _same(r[name], first), (name, n)
    return first


def _same(x, y):
    if isinstance(x, np.ndarray):
        return isinstance(y, np.ndarray) and np.array_equal(x, y)
    if isinstance(x, (tuple, list)):
        return len(x) == len(y) and all(_same(p, q) for p, q in zip(x, y))
    return x == y


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest should provide 8 virtual CPU devices"
    return Mesh(np.array(devs[:8]), axis_names=("cols",))


def _jplan(plan):
    return JMulPlan(**dataclasses.asdict(plan))


@pytest.mark.parametrize("kind", DRIVERS)
def test_sharded_driver_matches_reference(ranks, mesh, kind):
    """The sharded flagship, mfa and mfa_trunc products: equal to Python's
    and to the reference's sharded_mul_fn on 8 devices, digit for digit."""
    plan, a, b = OPS[kind]
    got = _whole(ranks, kind)
    assert cases.value(got) == a * b
    L = cdiv(1 << 14, DIGIT_BITS)
    want = np.asarray(jsharded_mul_fn(mesh, _jplan(plan), kind)(
        jnp.asarray(jdigits_from_int(a, L)), jnp.asarray(jdigits_from_int(b, L))))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", list(SPECTRA))
def test_sharded_spectrum_matches_reference(ranks, mesh, name):
    """The sharded forward's spectrum, gathered: equal mod p to the
    reference's mfa_fft_trunc_sqrt2 under its ShardCtx (the MFA layout at
    the full length too) at every kept position; and one all-to-all, no
    all-gather."""
    plan, a, _ = OPS["spectrum " + name]
    got, stats = _whole(ranks, "spectrum " + name)
    t = plan.trunc_mfa
    assert stats["all_to_all"] == 1 and stats["all_gather"] == 0, stats
    L = plan.W // DIGIT_BITS
    x = jsplit(jnp.asarray(jdigits_from_int(a, cdiv(plan.bits_a, DIGIT_BITS))), plan.bits1,
               plan.conv_len, L)
    want = np.asarray(jax.jit(lambda v: jfft_trunc_sqrt2(v, plan.w, plan.W, plan.n1, t,
                                                         con=JShardCtx(mesh)))(x))
    assert got.shape == (t, L)
    assert np.array_equal(normmod(torch.from_numpy(got)).numpy(),
                          normmod(torch.from_numpy(np.array(want[:t]))).numpy())


@pytest.mark.parametrize("name", list(UNEVEN))
def test_sharded_uneven_products(ranks, name):
    """Uneven operands and kept rows the ranks do not divide (padded at the
    exchange): exact."""
    plan, a, b = OPS["uneven " + name]
    got = _whole(ranks, "uneven " + name)
    assert got.shape == (out_len_digits(plan),) and cases.value(got) == a * b


def test_sharded_staged_and_garner(ranks):
    """The sharded staged flagship: the product exact at a depth-6 plan;
    at the hand-built plan mul and sqr exact with every pointwise's Garner
    hook (K = n1 = 8 rows of 128 digits) taken."""
    plan, a, b = OPS["staged"]
    assert cases.value(_whole(ranks, "staged")) == a * b
    plan, a, b = OPS["garner"]
    prod, sq, taken = _whole(ranks, "garner")
    assert cases.value(prod) == a * b and cases.value(sq) == a * a
    assert taken and all(taken), taken


def test_sharded_exchanges(ranks):
    """The counterpart of test_sharded_collective_is_all_to_all: each
    operand's forward is ONE all-to-all (both halves together), no
    all-gather before the pointwise, one all-to-all and one all-gather in
    the inverse; the unstaged flagship stacks both forwards into one."""
    plan, a, b = OPS["garner"]
    seen, out, flat = _whole(ranks, "exchanges")
    assert seen == [("forward a", 1, 0), ("forward b", 2, 0), ("pointwise", 2, 0),
                    ("inverse", 3, 1), ("unstaged", 2, 1)], seen
    assert cases.value(out) == cases.value(flat) == a * b


def test_sharded_dp_batch(ranks):
    """The data-parallel batch: ndev products exact (sharded_mul_many_step)
    and, past one rank, ndev + 1 pairs refused with ValueError."""
    n, _ = ranks
    out = _whole(ranks, "dp")
    assert out.shape[0] == n
    assert _whole(ranks, "dp uneven") == (n > 1)


@pytest.mark.parametrize("name", list(OUT_OF_CORE))
def test_sharded_out_of_core(ranks, name):
    """mul_huge / sqr_huge over the ranks with small chunks, exact; the
    passes sharded (exchanges run) where the reference's gates hold, and
    unsharded on every rank where one kept row cannot split."""
    n, _ = ranks
    plan, a, b = OPS["ooc " + name]
    got, stats, was_sharded = _whole(ranks, "ooc " + name)
    square = OUT_OF_CORE[name][1]
    assert cases.value(got) == (a * a if square else a * b)
    assert was_sharded == (name != "unsharded-k2=1" or n == 1)
    assert (stats["all_to_all"] > 0) == was_sharded, stats


def test_dryrun_multichip_4_ranks(capsys):
    """The reference's six dry-run steps on four CPU ranks."""
    dryrun.dryrun_multichip(4, device="cpu", backend="gloo", timeout=TIMEOUT)
    assert "dryrun_multichip OK on 4 devices" in capsys.readouterr().out


def test_rank_without_a_gpu_raises():
    """A rank asked for cuda that finds no card raises (no fallback to the
    CPU); here, where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_ranks(1, cases.run, ([],), device="cuda", backend="gloo", timeout=TIMEOUT)


def test_garner_hook_declines_a_group_the_ladder_cannot_hold():
    """The hook at K = n1 = 128 rows of M = 1024 digits (512 KB, past the
    ladder's buffer; the sharded staged flagship at 10^8 bits asks for it)
    is declined -- not consumed, no error -- and the product is the plain
    one."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 1 << 16, (128, 1024)).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, 1 << 16, (128, 1024)).astype(np.int32))
    steps = tuple(1 << j for j in range(7))
    assert not tfused.ladder_fits(128, 1024)
    with garner_post(1024, 128, steps) as cell:
        got = mulmod_ntt(x, y)
    assert not cell["consumed"]
    assert torch.equal(normmod(got), normmod(mulmod_ntt(x, y)))


@pytest.mark.parametrize("L,n2,trunc2", [(64, 16, 16), (64, 16, 5), (2048, 4, 4)])
def test_column_block_equals_its_columns_of_the_whole(L, n2, trunc2):
    """A rank's column block from global column off (the column kernel's
    plain version, and the truncate.py recursion at L 2048) equals those
    columns of the pass over all n1."""
    rng = np.random.default_rng(6)
    n1, cols, W = 8, 2, 16 * L
    w = 2 * W // (n1 * n2)                  # the length-n1 n2 MFA's root 2^w
    x = torch.from_numpy(rng.integers(-(1 << 17), 1 << 17, (2, n1, n2, L)).astype(np.int32))
    for kind in ("fwd", "inv"):
        whole = tmfa._run_cols(x, kind, w, W, trunc2)
        for off in range(0, n1, cols):
            blk = tmfa._run_cols(x[:, off:off + cols], kind, w, W, trunc2, n1=n1, off=off)
            assert torch.equal(blk[..., :trunc2, :], whole[:, off:off + cols, :trunc2])
