"""The flagship's truncated route (trunc_mfa < conv_len on an odd-w plan,
the shape of a 10^9 x 10^8-bit product at small sizes) against the
benchmark's plain reference, bignum_bench/reference.py `mul_digits`, and
the route's spans and copy counter.

The route runs staged (models/mul.py `_staged_flagship`, forced by the
threshold as tests/test_torch_staged.py forces it, with 256-row pointwise
chunks) and flat (`mpn_mul_flagship`), both through `_driver("flagship")`,
and the truncated MFA driver `mfa_trunc` runs at the same operand sizes.
Operands are seeded uniform digits with the top bit set, as the
benchmark's generator draws them.  No JAX here: the reference is plain
torch, written apart from the program."""

import pytest
import torch

from bignum_bench import generator, judge, reference
from mpir_fft_tpu_torch import kernels
from mpir_fft_tpu_torch.models import mul as tmul
from mpir_fft_tpu_torch.ops.fused import mfa_col_fits
from mpir_fft_tpu_torch.utils.params import MulPlan, plan_for_depth, validate

# odd w, trunc_mfa < conv_len; (depth, w, bits1, j1, j2, bits_a, bits_b)
PLANS = {
    # t 272 > h 256: the top layer both ways, the rebuild past trunc, a
    # truncate1 MFA of one row group on the right; L 8 columns (the column
    # kernel's route); two pointwise chunks of 256 and 16 rows
    "rebuild": validate(MulPlan(7, 1, 48, 245, 25, 11760, 1200, True)),
    # t 136 > h 128 at L 1028: the columns past L 1024 take the truncate
    # recursion with the cross table (ladder_pe on the card), as at L 2048
    "rebuild_pe": validate(MulPlan(6, 257, 512, 120, 12, 61440, 6144, True)),
    # t 224 <= h 256: the left half alone, no top layer, no rebuild
    "left": validate(MulPlan(7, 1, 48, 200, 20, 9600, 960, True)),
}
# a balanced full-length plan (tests/test_torch_trace.py's STAGED)
FULL = validate(MulPlan(5, 64, 1008, 40, 40, 40320, 40320, True))
NEW_SPANS = {"mf.trunc.top", "mf.mfa.trunc", "mf.trunc.rebuild", "mf.pw.rows"}


def _operands(plan: MulPlan, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    return (generator.random_digits(g, 1, plan.bits_a, "cpu")[0],
            generator.random_digits(g, 1, plan.bits_b, "cpu")[0])


def _mfa_trunc_plan(plan: MulPlan) -> MulPlan:
    """The shallowest plan of mfa_trunc at plan's sizes that truncates."""
    for depth in range(plan.depth, plan.depth + 4):
        q = plan_for_depth(plan.bits_a, plan.bits_b, depth, sqrt2=False)
        if q.trunc_mfa < q.conv_len:
            return q
    raise AssertionError(plan)


def _runner(plan: MulPlan, route: str, monkeypatch):
    """The driver of a route at plan, through _driver as mul() takes it."""
    if route == "mfa_trunc":
        return tmul._driver("mfa_trunc", _mfa_trunc_plan(plan))
    if route == "staged":
        monkeypatch.setattr(tmul, "_STAGED_THRESHOLD_ELEMS", 0)
        monkeypatch.setattr(tmul, "_PW_CHUNK_BYTES", 0)        # chunks of 256 rows
    assert tmul.flagship_is_staged(plan) == (route == "staged")
    return tmul._driver("flagship", plan)


def _check(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    want, roundoff = reference.mul_digits(a, b)
    assert roundoff < reference.ROUNDOFF_LIMIT
    assert judge.digits_differ(out, want) == 0


@pytest.mark.parametrize("route", ["staged", "flat", "mfa_trunc"])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_truncated_route_matches_the_plain_reference(name, route, monkeypatch):
    plan = PLANS[name]
    assert plan.w % 2 == 1 and plan.trunc_mfa < plan.conv_len
    assert (plan.trunc_mfa > plan.conv_len // 2) == name.startswith("rebuild")
    assert mfa_col_fits(plan.n2, plan.W // 16, False) == (name != "rebuild_pe")
    run = _runner(plan, route, monkeypatch)
    for seed in (2**31 + 3, 5):
        a, b = _operands(plan, seed)
        _check(run(a, b), a, b)


def _mf_spans(prof) -> list:
    return [ev for ev in prof.profiler.kineto_results.events() if ev.name().startswith("mf.")]


def _inside(ev, outer) -> bool:
    return any(o.start_ns() <= ev.start_ns() and
               ev.start_ns() + ev.duration_ns() <= o.start_ns() + o.duration_ns()
               for o in outer)


@pytest.mark.parametrize("name,route,want", [
    ("rebuild", "staged", NEW_SPANS),
    ("rebuild", "flat", NEW_SPANS - {"mf.pw.rows"}),
    ("left", "staged", {"mf.mfa.trunc", "mf.pw.rows"}),
    ("full", "staged", set()),
])
def test_a_traced_call_shows_the_truncation_spans_and_copies(name, route, want, monkeypatch):
    plan = PLANS.get(name, FULL)
    run = _runner(plan, route, monkeypatch)
    a, b = _operands(plan, 11)
    kernels.reset_launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = run(a, b)
    _check(out, a, b)
    evs = _mf_spans(prof)
    assert {ev.name() for ev in evs} & NEW_SPANS == want
    by = {n: [ev for ev in evs if ev.name() == n] for n in ("mf.fwd", "mf.pw", "mf.inv")}
    for ev in evs:
        if ev.name() == "mf.pw.rows":
            assert _inside(ev, by["mf.pw"])
        elif ev.name() in NEW_SPANS:
            assert _inside(ev, by["mf.fwd"] + by["mf.inv"]), ev.name()
    copied = kernels.COUNTERS["trunc_copy_bytes"]
    assert (copied > 0) == bool(want), copied
    kernels.reset_launches()
    assert kernels.COUNTERS["trunc_copy_bytes"] == 0


def test_the_truncated_route_enters_no_record_function_untraced(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span was recorded with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    plan = PLANS["rebuild"]
    a, b = _operands(plan, 13)
    for route in ("flat", "staged"):
        _check(_runner(plan, route, monkeypatch)(a, b), a, b)
