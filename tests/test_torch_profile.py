"""The port's stage profile (mpir_fft_tpu_torch/utils/profile.py
_stage_fns, profile_stages, profile_transforms) on the CPU.

For each of the seven drivers, and for the staged flagship, the stages
composed one after another give the driver's own product digit for digit
(they are the functions the driver runs: models.mul.driver_stages).  The
GEMM work the profile reckons from a plan equals what ops/ntt.py issues."""

import json
import pathlib
import random

import pytest
import torch

from mpir_fft_tpu_torch.models import mul as tmul
from mpir_fft_tpu_torch.ops import ntt as tntt
from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, digits_from_int, int_from_digits
from mpir_fft_tpu_torch.utils import profile
from mpir_fft_tpu_torch.utils.params import MulPlan, cdiv, choose_params, plan_for_depth, validate

REPO = pathlib.Path(__file__).resolve().parent.parent

# (driver, plan): tests/test_torch_drivers.py's cases, balanced and truncated
PLANS = [
    ("radix2", plan_for_depth(6000, 6000, 3, False)),
    ("sqrt2", plan_for_depth(6000, 6000, 3, True)),
    ("trunc", validate(MulPlan(6, 2, 32, 50, 10, 1600, 320, False))),
    ("trunc_sqrt2", validate(MulPlan(5, 1, 12, 70, 20, 840, 240, True))),
    ("mfa", plan_for_depth(6000, 6000, 3, False)),
    ("mfa_trunc", validate(MulPlan(6, 2, 32, 30, 10, 960, 320, False))),
    ("flagship", plan_for_depth(16000, 9000, 4, True)),
    ("flagship", plan_for_depth(30000, 6000, 8, True)),            # trunc_mfa < conv_len
]
# the staged flagship at tests/test_torch_staged.py's plans: zero-top even
# and odd w (the Garner hook taken), full length with j1 > h, truncated
STAGED = [
    validate(MulPlan(5, 64, 1008, 40, 40, 40320, 40320, True)),
    validate(MulPlan(7, 1, 48, 200, 200, 9600, 9600, True)),
    plan_for_depth(24000, 6000, 4, True),
    validate(MulPlan(5, 64, 992, 16, 15, 15800, 14600, True)),
]


def _operands(plan, seed):
    rnd = random.Random(seed)
    a = rnd.getrandbits(plan.bits_a) | 1 << (plan.bits_a - 1)
    b = rnd.getrandbits(plan.bits_b) | 1 << (plan.bits_b - 1)
    da = torch.from_numpy(digits_from_int(a, cdiv(plan.bits_a, DIGIT_BITS)))
    db = torch.from_numpy(digits_from_int(b, cdiv(plan.bits_b, DIGIT_BITS)))
    return a, b, da, db


def _compose(kind, plan, da, db):
    fwd, pw, inv, norm, combine, meta = profile._stage_fns(plan, kind)
    c = inv(pw(fwd(da), fwd(db)))
    return combine(c if norm is None else norm(c)), meta


@pytest.mark.parametrize("kind,plan", PLANS)
def test_stages_compose_to_the_driver(kind, plan):
    a, b, da, db = _operands(plan, plan.depth)
    got, meta = _compose(kind, plan, da, db)
    assert not meta["staged"]
    want = tmul._driver(kind, plan)(da, db)
    assert torch.equal(got, want)
    assert int_from_digits(got.numpy()) == a * b


@pytest.mark.parametrize("plan", STAGED)
def test_staged_stages_compose_to_the_staged_flagship(plan, monkeypatch):
    """With every plan staged and one-n1-group chunks, the staged stages
    (the chunked pointwise writing the first spectrum in place) equal the
    staged route's product, digit for digit."""
    monkeypatch.setattr(tmul, "_STAGED_THRESHOLD_ELEMS", 0)
    monkeypatch.setattr(tmul, "_PW_CHUNK_BYTES", 1)
    a, b, da, db = _operands(plan, plan.w)
    got, meta = _compose("flagship", plan, da, db)
    assert meta["staged"] and meta["pointwise_rows"] == plan.trunc_mfa
    assert torch.equal(got, tmul._driver("flagship", plan)(da, db))
    assert torch.equal(got, tmul._staged_flagship(plan)(da, db))
    assert int_from_digits(got.numpy()) == a * b


def test_stage_profile_refuses_out_of_core_plans():
    plan = choose_params(4 * 10**9, 4 * 10**9, True)
    assert tmul.flagship_is_huge(plan)
    with pytest.raises(ValueError, match="out-of-core"):
        profile._stage_fns(plan, "flagship")


# the reference artifact's stage keys (artifacts/PROFILE_r05_1e9.json)
REF_KEYS = {"bits", "driver", "plan", "staged", "device", "fwd_a_s", "fwd_b_s",
            "inverse_s", "combine_s", "total_s"}


@pytest.mark.parametrize("driver,staged", [("flagship", False), ("flagship", True),
                                           ("mfa_trunc", False), ("trunc_sqrt2", False)])
def test_profile_stages_on_the_cpu(driver, staged, monkeypatch):
    monkeypatch.setenv("MPIR_FFT_TUNE", "0")
    if staged:
        monkeypatch.setattr(tmul, "_STAGED_THRESHOLD_ELEMS", 0)
    r = profile.profile_stages(20000, reps=1, driver=driver, device="cpu")
    assert REF_KEYS <= set(r) and r["clock"] == "host" and r["device"] == "cpu"
    pw = "pointwise_rows_s" if staged else "pointwise_s"
    assert r["staged"] is staged and pw in r
    assert ("normalize_s" in r) == (driver != "flagship")
    stages = [k for k in r if k.endswith("_s") and k not in ("total_s", "route_s")]
    assert all(r[k] > 0 for k in stages + ["route_s"])
    assert r["total_s"] == sum(r[k] for k in stages)
    assert r["stages_over_route"] == r["total_s"] / r["route_s"]
    plan = choose_params(20000, 20000, tmul.DRIVERS[driver][1])
    assert (r["plan"]["depth"], r["plan"]["w"]) == (plan.depth, plan.w)
    assert r["fwd_ladder_bytes"] > 0 and r["pointwise_gemm_ops"] == 0   # L 24: the schoolbook
    if staged:
        ref = json.loads((REPO / "artifacts" / "PROFILE_r05_1e9.json").read_text())
        assert {k for k in ref if k.endswith("_s") and "_per_" not in k} <= set(r)


def test_profile_transforms_on_the_cpu():
    r = profile.profile_transforms(5, 2, reps=1, batch=3, device="cpu")
    names = ("radix2", "sqrt2", "mfa", "negacyclic")
    assert {f"{d}{n}_s" for d in ("fft_", "ifft_") for n in names} <= set(r)
    assert (r["W"], r["L"], r["batch"], r["clock"]) == (64, 4, 3, "host")


@pytest.mark.parametrize("rows,W,recursive", [
    (3, 64 * 16, True),           # dense tier at M 64, batch padded to 32 rows
    (40, 256 * 16, True),         # dense tier, M 256
    (2, 4096 * 16, True),         # the 4-step tier
    (1, 6144 * 16, True),         # recursion: inner rings of Lp 64 on the dense tier
    (4, 48 * 16, True),           # the schoolbook: no GEMM
    (20, 96 * 16, False),         # the leaf where it serves (the other drivers)
])
def test_pointwise_gemm_ops_equal_issued(rows, W, recursive, monkeypatch):
    issued = []
    real = tntt._dot_raw

    def spy(planes, blk):
        n = planes.shape[0]
        issued.append(2 * (32 if n <= 16 else n) * planes.shape[1] * blk.shape[1])
        return real(planes, blk)

    monkeypatch.setattr(tntt, "_dot_raw", spy)
    L = W // DIGIT_BITS
    g = torch.Generator().manual_seed(rows)
    fa = torch.randint(0, 1 << 16, (rows, L), generator=g, dtype=torch.int32)
    fb = torch.randint(0, 1 << 16, (rows, L), generator=g, dtype=torch.int32)
    tmul._pointwise(fa, fb, W, recursive)
    assert sum(issued) == profile.pointwise_gemm_ops(rows, W, recursive)
    assert (sum(issued) > 0) == (L not in (48, 96))
