"""The port's spans and counters (mpir_fft_tpu_torch/kernels: span,
spanned, COUNTERS) on the CPU.

With no profiler recording, a span is a shared no-op: a product and a
Fermat-ring product run without entering any record function.  Under a
torch.profiler window the staged flagship, mulmod_fft and the host API
record the stages as "mf.*" host spans, nested by containment.  The
int8_ops counter equals the GEMM operations the plan implies
(ops/ntt.py gemm_ops, as utils/profile.py pointwise_gemm_ops routes it)."""

import random

import pytest
import torch

from mpir_fft_tpu_torch import kernels
from mpir_fft_tpu_torch.models import mul as tmul
from mpir_fft_tpu_torch.ops import mulmod as tmulmod
from mpir_fft_tpu_torch.ops import ntt as tntt
from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, digits_from_int, int_from_digits
from mpir_fft_tpu_torch.utils import profile
from mpir_fft_tpu_torch.utils.params import MulPlan, cdiv, validate

# the staged flagship at a zero-top plan of L 128 (the dense NTT tier, the
# Garner hook taken): tests/test_torch_staged.py's first plan
STAGED = validate(MulPlan(5, 64, 1008, 40, 40, 40320, 40320, True))
# a ring the base leaf does not serve: mulmod_fft over 256 inner rings of 32 digits
RING_N = 49152


def _digits(v: int, n: int) -> torch.Tensor:
    return torch.from_numpy(digits_from_int(v, n))


def _tree(prof) -> list:
    """The window's mf.* spans as nested [name, [children]], by containment."""
    evs = sorted((ev for ev in prof.profiler.kineto_results.events()
                  if ev.name().startswith("mf.")),
                 key=lambda ev: (ev.start_ns(), -ev.duration_ns()))
    root: list = []
    stack: list = []                    # (end_ns, children list)
    for ev in evs:
        start = ev.start_ns()
        while stack and stack[-1][0] <= start:
            stack.pop()
        node = [ev.name(), []]
        (stack[-1][1] if stack else root).append(node)
        stack.append((start + ev.duration_ns(), node[1]))
    return root


def _names(nodes) -> list[str]:
    return [n for n, _ in nodes]


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _tree(prof)


def test_no_profiler_enters_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span was recorded with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setenv("MPIR_FFT_TUNE", "0")
    assert kernels.span("a") is kernels.span("b")
    rnd = random.Random(5)
    a, b = rnd.getrandbits(50000), rnd.getrandbits(50000)      # L 32: the dense NTT
    assert tmul.mul(a, b, device="cpu") == a * b
    x, y = rnd.getrandbits(RING_N), rnd.getrandbits(RING_N)
    assert tmulmod.mulmod_int(x, y, RING_N, device="cpu") == x * y % ((1 << RING_N) + 1)


def test_staged_flagship_spans_nest_by_stage():
    rnd = random.Random(1)
    a, b = rnd.getrandbits(STAGED.bits_a), rnd.getrandbits(STAGED.bits_b)
    run = tmul._staged_flagship(STAGED)
    n = cdiv(STAGED.bits_a, DIGIT_BITS)
    da, db = _digits(a, n), _digits(b, n)
    out, tree = _profiled(lambda: run(da, db))
    assert int_from_digits(out.numpy()) == a * b
    assert _names(tree) == ["mf.flagship"]
    stages = tree[0][1]
    assert _names(stages) == ["mf.split", "mf.fwd", "mf.split", "mf.fwd", "mf.pw", "mf.inv",
                              "mf.combine"]
    pw = stages[4][1]
    assert _names(pw) == ["mf.mulmod"]
    assert _names(pw[0][1]) == ["mf.ntt.dense"]
    gemms = pw[0][1][0][1]
    assert _names(gemms) == ["mf.int8_gemm"] * 9                # 3 primes x (2 fwd + 1 inv)
    assert all(children == [] for _, children in gemms)


def test_mulmod_fft_spans_nest_by_stage():
    plan = tmulmod.inner_plan(RING_N)
    assert plan is not None and plan.b % DIGIT_BITS == 0
    rnd = random.Random(2)
    x, y = rnd.getrandbits(RING_N), rnd.getrandbits(RING_N)
    L = RING_N // DIGIT_BITS
    out, tree = _profiled(lambda: tmulmod.mulmod(_digits(x, L), _digits(y, L), RING_N))
    assert int_from_digits(out.numpy()) % ((1 << RING_N) + 1) == x * y % ((1 << RING_N) + 1)
    assert _names(tree) == ["mf.mulmod"]
    stages = tree[0][1]
    assert _names(stages) == ["mf.split", "mf.fwd", "mf.split", "mf.fwd", "mf.pw", "mf.inv",
                              "mf.norm"]
    inner = stages[4][1]
    assert _names(inner) == ["mf.mulmod"]                       # the inner rings' own
    assert _names(inner[0][1]) == ["mf.ntt.dense"]


def test_host_api_spans_wrap_the_conversions(monkeypatch):
    monkeypatch.setenv("MPIR_FFT_TUNE", "0")
    rnd = random.Random(3)
    a, b = rnd.getrandbits(50000), rnd.getrandbits(50000)
    got, tree = _profiled(lambda: tmul.mul(a, b, device="cpu"))
    assert got == a * b
    assert _names(tree) == ["mf.mul"]
    assert _names(tree[0][1]) == ["mf.digits_from_int", "mf.h2d", "mf.digits_from_int",
                                  "mf.h2d", "mf.flagship", "mf.d2h", "mf.int_from_digits"]
    x, y = rnd.getrandbits(RING_N), rnd.getrandbits(RING_N)
    got, tree = _profiled(lambda: tmulmod.mulmod_int(x, y, RING_N, device="cpu"))
    assert got == x * y % ((1 << RING_N) + 1)
    assert _names(tree) == ["mf.mulmod_int"]
    assert _names(tree[0][1]) == ["mf.digits_from_int", "mf.h2d", "mf.digits_from_int",
                                  "mf.h2d", "mf.mulmod", "mf.d2h", "mf.int_from_digits"]


def _staged_product():
    rnd = random.Random(4)
    a, b = rnd.getrandbits(STAGED.bits_a), rnd.getrandbits(STAGED.bits_b)
    n = cdiv(STAGED.bits_a, DIGIT_BITS)
    tmul._staged_flagship(STAGED)(_digits(a, n), _digits(b, n))
    return profile.pointwise_gemm_ops(STAGED.trunc_mfa, STAGED.W, True)


def _ring_product():
    L = RING_N // DIGIT_BITS
    rnd = random.Random(6)
    tmulmod.mulmod(_digits(rnd.getrandbits(RING_N), L), _digits(rnd.getrandbits(RING_N), L),
                   RING_N)
    return profile.pointwise_gemm_ops(1, RING_N, True)


def _ntt_product(B, M):
    def run():
        g = torch.Generator().manual_seed(M)
        x = torch.randint(0, 1 << 16, (B, M), generator=g, dtype=torch.int32)
        tntt.mulmod_ntt(x, x.clone())
        return tntt.gemm_ops(B, M)
    return run


@pytest.mark.parametrize("case,pair", [
    (_staged_product, False),             # the staged flagship's dense tier, M 128
    (_ring_product, False),               # mulmod_fft's inner rings, M 32
    (_ntt_product(3, 64), False),         # dense tier, 3 rows padded to 32
    (_ntt_product(1, 4096), False),       # the 4-step tier
    (_ntt_product(5, 256), True),         # the pair tier (MPIR_FFT_NTT_PAIR=1)
])
def test_int8_ops_count_the_gemms_the_plan_implies(case, pair, monkeypatch):
    if pair:
        monkeypatch.setenv("MPIR_FFT_NTT_PAIR", "1")
    kernels.reset_launches()
    want = case()
    assert want > 0 and kernels.COUNTERS["int8_ops"] == want
    kernels.reset_launches()
    assert kernels.COUNTERS["int8_ops"] == 0


def test_profile_host_steps_come_from_the_spans(monkeypatch):
    monkeypatch.setenv("MPIR_FFT_TUNE", "0")
    rnd = random.Random(7)
    a, b = rnd.getrandbits(50000), rnd.getrandbits(50000)
    steps, peak = profile.host_steps(lambda: tmul.mul(a, b, device="cpu"), "mf.mul",
                                     "mf.flagship", "flagship", device="cpu")
    assert list(steps) == ["planner", "digits_from_int x2", "host to device", "device to host",
                           "int_from_digits", "flagship"]
    assert peak == 0 and all(v > 0 for v in steps.values())
    x, y = rnd.getrandbits(RING_N), rnd.getrandbits(RING_N)
    steps, _ = profile.host_steps(lambda: tmulmod.mulmod_int(x, y, RING_N, device="cpu"),
                                  "mf.mulmod_int", "mf.mulmod", "mulmod", device="cpu")
    assert set(steps) == set(profile.HOST_STEPS) | {"mulmod"}
    assert all(v > 0 for v in steps.values())


def test_span_ms_counts_a_nested_span_of_the_same_name_once():
    L = RING_N // DIGIT_BITS
    rnd = random.Random(8)
    x, y = _digits(rnd.getrandbits(RING_N), L), _digits(rnd.getrandbits(RING_N), L)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tmulmod.mulmod(x, y, RING_N)
    outer = [ev for ev in prof.profiler.kineto_results.events() if ev.name() == "mf.mulmod"]
    assert len(outer) == 2                                      # the ring's and its inner rings'
    ms = profile.span_ms(prof)
    assert ms["mf.mulmod"] == max(ev.duration_ns() for ev in outer) / 1e6
