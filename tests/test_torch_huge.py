"""The port's out-of-core flagship (models/huge.py), its balanced-pieces
route (models/mul.py _mul_piecewise), mul_many and the package API, against
the JAX package on the CPU and against Python's products.

The huge engine runs at the reference's own test plans (tests/test_huge.py)
with CHUNK_BYTES and PW_CHUNK_BYTES shrunk to 64 KB in both packages, so
every pass runs several chunks.  Between passes both engines keep
coefficients canonical, so their stores are compared digit for digit after
the forward and after the pointwise, and the products as integers.  The
routes of the large plans are compared from the plans alone: no large int
is built.  All arithmetic is integer: the tolerance is exact."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpir_fft_tpu.models import huge as jhuge
from mpir_fft_tpu.models import mul as jmul
from mpir_fft_tpu.utils import params as jparams
from mpir_fft_tpu_torch.models import huge as thuge
from mpir_fft_tpu_torch.models import mul as tmul
from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, digits_from_int, int_from_digits
from mpir_fft_tpu_torch.utils import params as tparams
from mpir_fft_tpu_torch.utils.params import MulPlan, cdiv, plan_for_depth, validate

from test_torch_refusal import DEPTHS, SIZES

REPO = pathlib.Path(__file__).resolve().parent.parent


def _rand_int(rng, bits):
    v = int.from_bytes(rng.bytes(cdiv(bits, 8)), "little")
    v |= 1 << (bits - 1)
    return v & ((1 << bits) - 1)


@pytest.fixture
def small_chunks(monkeypatch):
    """Several chunks and column blocks a pass, in both packages."""
    for mod in (jhuge, thuge):
        monkeypatch.setattr(mod, "CHUNK_BYTES", 64 << 10)
        monkeypatch.setattr(mod, "PW_CHUNK_BYTES", 64 << 10)


def _rows(store, unpack, to_np):
    """The rows of an R-form store as one int32 array (the -1 form
    unpacked)."""
    return np.concatenate([to_np(unpack(u, m)) for u, m in store.parts])


def _jrows(store):
    return _rows(store, jhuge._unpack, np.asarray)


def _trows(store):
    return _rows(store, thuge._unpack, lambda t: t.numpy())


def _layout(plan):
    h = plan.conv_len // 2
    return "even" if plan.w % 2 == 0 else ("odd_t_le_h" if plan.trunc_mfa <= h else "odd_t_gt_h")


def _jdigits(v, bits):
    return jnp.asarray(digits_from_int(v, cdiv(bits, DIGIT_BITS)))


def _tdigits(v, bits):
    return torch.from_numpy(digits_from_int(v, cdiv(bits, DIGIT_BITS)))


def _run_both(plan, a, b, ba, bb, square):
    """Both engines stage by stage on the same operands: the forward stores,
    the pointwise's stores, then the product digits."""
    ja, ta = _jdigits(a, ba), _tdigits(a, ba)
    jfa, tfa = jhuge._forward(ja, plan, plan.j1), thuge._forward(ta, plan, plan.j1)
    assert np.array_equal(_trows(tfa), _jrows(jfa))
    jfb = tfb = None
    if not square:
        jb, tb = _jdigits(b, bb), _tdigits(b, bb)
        jfb, tfb = jhuge._forward(jb, plan, plan.j2), thuge._forward(tb, plan, plan.j2)
        assert np.array_equal(_trows(tfb), _jrows(jfb))
    jL, jR = jhuge._pointwise_rows(jfa, jfb, plan)
    tL, tR = thuge._pointwise_rows(tfa, tfb, plan)
    assert np.array_equal(_trows(tL), _jrows(jL))
    if jR.parts:
        assert np.array_equal(_trows(tR), _jrows(jR))
    else:
        assert not tR.parts
    want = int_from_digits(np.asarray(jhuge._inverse_and_combine(jL, jR, plan)))
    got = int_from_digits(thuge._inverse_and_combine(tL, tR, plan).numpy())
    return got, want


CASES = [
    # (bits_a, bits_b, depth, layout): the reference's tests/test_huge.py cases
    pytest.param(100_000, 100_000, 7, "odd_t_gt_h", id="odd-t>h"),
    pytest.param(50_000, 50_000, 5, "even", id="even-w"),
    pytest.param(150_000, 150_000, 7, "even", id="even-w-deep"),
]


@pytest.mark.parametrize("ba,bb,depth,layout", CASES)
def test_mul_huge_matches_reference(small_chunks, rng, ba, bb, depth, layout):
    plan = plan_for_depth(ba, bb, depth, sqrt2=True)
    assert _layout(plan) == layout, "plan drifted; update CASES"
    assert thuge.huge_serves(plan) and jhuge.huge_serves(plan)
    a, b = _rand_int(rng, ba), _rand_int(rng, bb)
    got, want = _run_both(plan, a, b, ba, bb, square=False)
    assert got == want == a * b
    out = thuge.mul_huge(_tdigits(a, ba), _tdigits(b, bb), plan)
    assert out.shape == (tmul.out_len_digits(plan),)
    assert int_from_digits(out.numpy()) == a * b


def test_mul_huge_odd_t_le_h(small_chunks, rng):
    """The odd-w trunc <= h layout, hand-built as the reference's test does
    (planners never waste half the convolution)."""
    plan = validate(MulPlan(6, 7, 160, 63, 63, 10_000, 10_000, True))
    assert _layout(plan) == "odd_t_le_h" and thuge.huge_serves(plan)
    a, b = _rand_int(rng, 10_000), _rand_int(rng, 10_000)
    got, want = _run_both(plan, a, b, 10_000, 10_000, square=False)
    assert got == want == a * b


def test_sqr_huge_matches_reference(small_chunks, rng):
    plan = plan_for_depth(100_000, 100_000, 7, sqrt2=True)
    assert _layout(plan) == "odd_t_gt_h"
    a = _rand_int(rng, 100_000)
    got, want = _run_both(plan, a, a, 100_000, 100_000, square=True)
    assert got == want == a * a
    assert int_from_digits(thuge.sqr_huge(_tdigits(a, 100_000), plan).numpy()) == a * a


def test_packing_round_trip():
    """_pack / _unpack keep canonical values, the -1 residue included, in
    16-bit planes (0xFFFF digits among them)."""
    x = torch.tensor([[0xFFFF, 0, 7, 0xFFFF], [-1, 0, 0, 0], [1 << 16, 0, 0, 0],
                      [0, 0, 0, 1 << 16]], dtype=torch.int32)      # 2^W == -1
    u, m = thuge._pack(x)
    assert u.dtype == torch.int16 and m.tolist() == [0, 1, 0, 1]
    want = torch.tensor([[0xFFFF, 0, 7, 0xFFFF], [-1, 0, 0, 0], [0, 1, 0, 0], [-1, 0, 0, 0]],
                        dtype=torch.int32)
    assert torch.equal(thuge._unpack(u, m), want)


# ---------------------------------------------------------------------------
# which route mul / sqr take past the threshold (plans only, no large int)
# ---------------------------------------------------------------------------

class _Took(Exception):
    pass


def _reference_route(plan, square):
    """The route the reference's mul / sqr give a flagship plan (its
    models/mul.py:588-612, :718-719), from its own predicates."""
    if not square and jmul._piecewise_serves(plan):
        return "pieces"
    try:
        jmul._require_huge_servable(plan)
    except ValueError:
        return "refused"
    return ("huge" if jmul.flagship_is_huge(plan) else
            "staged" if jmul.flagship_is_staged(plan) else "flat")


def _port_route(monkeypatch, plan, square):
    """The route the port's mul / sqr actually take: every route's entry
    replaced by a recorder, the conversions by stand-ins."""
    def took(name):
        def fn(*args, **kwargs):
            raise _Took(name)
        return fn

    monkeypatch.setattr(tmul, "_select_plan", lambda *args, **kwargs: plan)
    monkeypatch.setattr(tmul, "digits_from_int", lambda v, L: np.zeros(1, np.int32))
    monkeypatch.setattr(tmul, "mul_huge", took("huge"))
    monkeypatch.setattr(tmul, "sqr_huge", took("huge"))
    monkeypatch.setattr(tmul, "_staged_flagship", lambda p: took("staged"))
    monkeypatch.setattr(tmul, "mpn_mul_flagship", took("flat"))
    monkeypatch.setattr(tmul, "mpn_sqr_flagship", took("flat"))
    monkeypatch.setattr(tmul, "_mul_piecewise", took("pieces"))
    monkeypatch.setitem(tmul.DRIVERS, "flagship", (took("flat"), True))
    a = 1 << 9000
    try:
        tmul.sqr(a, device="cpu") if square else tmul.mul(a, a, device="cpu")
    except _Took as e:
        return e.args[0]
    except ValueError:
        return "refused"
    raise AssertionError("no route was taken")


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("bits_a,bits_b", SIZES)
def test_route_matches_reference(monkeypatch, bits_a, bits_b, depth):
    """flagship_is_huge and the route mul and sqr take (out of core, pieces,
    staged, whole or refused) are the reference's for every plan of the
    refusal sizes."""
    monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    if depth is None:
        jplan = jparams.choose_params(bits_a, bits_b, sqrt2=True)
        tplan = tparams.choose_params(bits_a, bits_b, sqrt2=True)
    else:
        jplan = jparams.plan_for_depth(bits_a, bits_b, depth, sqrt2=True)
        tplan = tparams.plan_for_depth(bits_a, bits_b, depth, sqrt2=True)
    assert dataclasses.asdict(jplan) == dataclasses.asdict(tplan)
    assert tmul.flagship_is_huge(tplan) == jmul.flagship_is_huge(jplan)
    assert tmul.flagship_is_staged(tplan) == jmul.flagship_is_staged(jplan)
    for square in (False, True):
        with monkeypatch.context() as m:
            assert _port_route(m, tplan, square) == _reference_route(jplan, square), square


def test_routes_cover_every_outcome(monkeypatch):
    """The sizes above reach out of core, pieces and staged, and the 4x10^9
    balanced plan runs out of core in both packages while 2x10^9 (exactly
    2^29 elements) stays staged."""
    monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    seen = {_reference_route(jparams.choose_params(a, b, sqrt2=True), False) for a, b in SIZES}
    assert {"huge", "pieces", "staged"} <= seen, seen
    p4 = tparams.choose_params(4_000_000_000, 4_000_000_000, sqrt2=True)
    p2 = tparams.choose_params(2_000_000_000, 2_000_000_000, sqrt2=True)
    assert tmul.flagship_is_huge(p4) and not tmul.flagship_is_huge(p2)
    assert p2.conv_len * (p2.W // DIGIT_BITS) == tmul._HUGE_THRESHOLD_ELEMS
    assert thuge.huge_serves(p2)


# ---------------------------------------------------------------------------
# balanced pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("swap", [False, True])
def test_mul_piecewise_matches_reference(monkeypatch, rng, swap):
    """An extreme-uneven product past a lowered threshold (both packages) as
    balanced pieces: equal to the reference's mul and to Python, and the
    smaller operand converted to digits once (the reference converts it
    once a piece)."""
    monkeypatch.setenv("MPIR_FFT_TUNE", "0")
    monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    a, b = _rand_int(rng, 20000), _rand_int(rng, 9000)
    plan = tparams.choose_params(20000, 9000, sqrt2=True)
    elems = plan.conv_len * (plan.W // DIGIT_BITS)
    monkeypatch.setattr(jmul, "_HUGE_THRESHOLD_ELEMS", elems - 1)
    monkeypatch.setattr(tmul, "_HUGE_THRESHOLD_ELEMS", elems - 1)
    assert tmul._piecewise_serves(plan)
    seen = []
    real = tmul.digits_from_int

    def counting(v, L):
        seen.append(v)
        return real(v, L)

    monkeypatch.setattr(tmul, "digits_from_int", counting)
    x, y = (b, a) if swap else (a, b)
    got = tmul.mul(x, y, device="cpu")
    assert got == a * b
    assert sum(v == b for v in seen) == 1
    # b once, the two 9000-bit pieces, the 2000-bit piece's product (on the host)
    assert len(seen) == 4
    jmul._jitted_driver.cache_clear()
    try:
        assert jmul.mul(x, y) == got
    finally:
        jmul._jitted_driver.cache_clear()


# ---------------------------------------------------------------------------
# mul_many and the API
# ---------------------------------------------------------------------------

def test_mul_many_matches_reference(monkeypatch, rng):
    """Mixed sizes in one batched call (the reference's test_mul_many_batched
    pairs), a one-pair batch and an empty one: equal to the reference's
    mul_many and to Python."""
    monkeypatch.setenv("MPIR_FFT_TUNE", "0")
    monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    pairs = [
        (_rand_int(rng, 17000), _rand_int(rng, 15000)),
        (_rand_int(rng, 9000), _rand_int(rng, 15000)),
        (_rand_int(rng, 17000), _rand_int(rng, 4000)),
        (_rand_int(rng, 12345), _rand_int(rng, 6789)),
    ]
    calls = []
    real = tmul._driver
    monkeypatch.setattr(tmul, "_driver", lambda k, p: calls.append(k) or real(k, p))
    got = tmul.mul_many(pairs, device="cpu")
    assert calls == ["flagship"]            # one batched driver call
    assert got == [a * b for a, b in pairs]
    assert jmul.mul_many(pairs) == got
    one = [(pairs[0][0], pairs[1][1])]
    assert tmul.mul_many(one, device="cpu") == jmul.mul_many(one) == [one[0][0] * one[0][1]]
    assert tmul.mul_many([], device="cpu") == jmul.mul_many([]) == []
    assert tmul.mul_many([(0, 5), (3, 0)], device="cpu") == [0, 0]
    with pytest.raises(ValueError):
        tmul.mul_many([(1, -1)], device="cpu")


@pytest.mark.parametrize("driver", ["mfa", "trunc_sqrt2"])
def test_mul_many_other_drivers(rng, driver):
    pairs = [(_rand_int(rng, 12000), _rand_int(rng, 9000)), (_rand_int(rng, 7000), 3),
             (5, _rand_int(rng, 8000))]
    assert tmul.mul_many(pairs, driver=driver, device="cpu") == [a * b for a, b in pairs]


def test_mul_many_staged_plans_loop(monkeypatch, rng):
    """A plan that runs staged loops over mul, one product a call."""
    monkeypatch.setattr(tmul, "_STAGED_THRESHOLD_ELEMS", 0)
    pairs = [(_rand_int(rng, 9000), _rand_int(rng, 8000)) for _ in range(3)]
    calls = []
    real = tmul.mul
    monkeypatch.setattr(tmul, "mul", lambda a, b, d, dev: calls.append(1) or real(a, b, d, dev))
    assert tmul.mul_many(pairs, device="cpu") == [a * b for a, b in pairs]
    assert len(calls) == 3


def test_package_api():
    """The reference's eight top-level names, the same objects as in the
    modules, exact through the package."""
    import mpir_fft_tpu
    import mpir_fft_tpu_torch as m
    from mpir_fft_tpu_torch.ops import mulmod as tmm

    names = ["DRIVERS", "choose_params", "mul", "mul_many", "mulmod", "mulmod_int",
             "plan_for_depth", "sqr"]
    assert sorted(m.__all__) == sorted(n for n in mpir_fft_tpu.__all__ if n != "__version__")
    assert sorted(m.__all__) == names
    assert m.mul is tmul.mul and m.mul_many is tmul.mul_many and m.DRIVERS is tmul.DRIVERS
    assert m.mulmod is tmm.mulmod and m.plan_for_depth is tparams.plan_for_depth
    assert sorted(m.DRIVERS) == sorted(jmul.DRIVERS)
    a, b = 3 ** 12000, 5 ** 9000
    assert m.mul(a, b, device="cpu") == a * b and m.sqr(b, device="cpu") == b * b
    assert m.mul_many([(a, b), (b, b)], device="cpu") == [a * b, b * b]


def _port_sources():
    return sorted((REPO / "mpir_fft_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax or the JAX
    package: by their source, and by what importing every module loads."""
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "mpir_fft_tpu"), (path.name, name)
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            for p in _port_sources() if p.name != "chip_smoke.py"]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mpir_fft_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
