"""The port's plan tuner (mpir_fft_tpu_torch/utils/tune.py) against the
reference's (mpir_fft_tpu/utils/tune.py), and its own mechanics on the CPU:
the device-keyed cache, the noise gate, which candidate failures are
skipped, and models.mul._select_plan's lookup.

Every test that touches a cache points MPIR_FFT_TUNE_CACHE at a file under
tmp_path.  The reference's tune and params modules compile nothing."""

import builtins
import dataclasses
import json
import random

import pytest
import torch

from mpir_fft_tpu.utils import params as jparams
from mpir_fft_tpu.utils import tune as jtune
from mpir_fft_tpu_torch.models import mul as tmul
from mpir_fft_tpu_torch.utils import tune
from mpir_fft_tpu_torch.utils.interop import plan_from_reference
from mpir_fft_tpu_torch.utils.params import choose_params, plan_for_depth

SIZES = [(20000, 20000), (100_000, 100_000), (10**6, 10**6), (10**7, 10**7), (10**8, 10**8),
         (10**9, 10**9), (10**9, 10**8), (3 * 10**7, 10**6), (50000, 9000), (4 * 10**9, 4 * 10**9)]


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv("MPIR_FFT_TUNE_CACHE", str(path))
    monkeypatch.delenv("MPIR_FFT_TUNE", raising=False)
    monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    return path


def _triples(plans):
    return [(p.depth, p.w, p.trunc) for p in plans]


@pytest.mark.parametrize("sqrt2", [True, False])
@pytest.mark.parametrize("bits_a,bits_b", SIZES)
def test_buckets_keys_candidates_match_reference(bits_a, bits_b, sqrt2, monkeypatch):
    monkeypatch.delenv("MPIR_FFT_NTT", raising=False)
    assert tune._bucket(bits_a) == jtune._bucket(bits_a)
    assert tune._bucket(bits_b) == jtune._bucket(bits_b)
    for driver in ("flagship", "mfa_trunc"):
        assert tune._key(driver, bits_a, bits_b) == jtune._key(driver, bits_a, bits_b)
    assert (_triples(tune.candidate_plans(bits_a, bits_b, sqrt2))
            == _triples(jtune.candidate_plans(bits_a, bits_b, sqrt2)))


@pytest.mark.parametrize("driver,bits_a,bits_b,shift", [
    ("flagship", 30000, 30000, 1), ("flagship", 10**7, 10**7, -1), ("flagship", 10**9, 10**8, 2),
    ("mfa", 100_000, 60000, 1), ("trunc", 2 * 10**6, 10**6, -2)])
def test_cached_plan_matches_reference(driver, bits_a, bits_b, shift, cache_file):
    """One cache file with a "cpu" entry: both packages' cached_plan give
    the same plan (the reference reads it as its CPU device's)."""
    sqrt2 = tmul.DRIVERS[driver][1]
    depth = choose_params(bits_a, bits_b, sqrt2).depth + shift
    key = tune._key(driver, bits_a, bits_b)
    cache_file.write_text(json.dumps({"cpu": {key: {"depth": depth, "w": 0}}}))
    assert jtune._device_tag() == "cpu"
    ref = jtune.cached_plan(bits_a, bits_b, driver)
    got = tune.cached_plan(bits_a, bits_b, driver, "cpu")
    assert got is not None and got.depth == depth
    assert got == plan_from_reference(dataclasses.asdict(ref))


def test_foreign_device_entries_invisible(cache_file):
    bits = 30000
    key = tune._key("flagship", bits, bits)
    depth = choose_params(bits, bits, True).depth + 1
    cache_file.write_text(json.dumps({"NVIDIA H100 80GB HBM3": {key: {"depth": depth}},
                                      "TPU v5 lite": {key: {"depth": depth}}}))
    assert tune.cached_plan(bits, bits, "flagship", "cpu") is None
    assert tmul._select_plan(bits, bits, "flagship", "cpu") == choose_params(bits, bits, True)
    # a legacy flat file counts as the reading device's
    cache_file.write_text(json.dumps({key: {"depth": depth}}))
    assert tune.cached_plan(bits, bits, "flagship", "cpu").depth == depth


def test_reference_seed_never_read(tmp_path, monkeypatch):
    """The committed .tune_cache.json (TPU entries) is never opened, not
    even where it holds entries every device would read (a flat file)."""
    bits = 30000
    key = tune._key("flagship", bits, bits)
    (tmp_path / ".tune_cache.json").write_text(json.dumps({key: {"depth": 3}}))
    monkeypatch.setattr(tune, "_repo_root", lambda: str(tmp_path))
    monkeypatch.delenv("MPIR_FFT_TUNE_CACHE", raising=False)
    monkeypatch.delenv("MPIR_FFT_TUNE", raising=False)
    opened = []
    real_open = builtins.open

    def spy(file, *args, **kwargs):
        opened.append(str(file))
        return real_open(file, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", spy)
    assert tune.cached_plan(bits, bits, "flagship", "cpu") is None
    assert tmul._select_plan(bits, bits, "flagship", "cpu") == choose_params(bits, bits, True)
    assert opened and not any(p.endswith(".tune_cache.json") for p in opened), opened
    assert tune._cache_path() == str(tmp_path / ".cache" / "tune_cache_torch.json")


@pytest.mark.parametrize("off", ["0", "off", "false"])
def test_cached_depth_changes_select_plan_and_mul_stays_exact(off, cache_file, monkeypatch):
    """A cached depth changes the plan mul() picks on that device, mul()
    through it stays exact, and MPIR_FFT_TUNE=0 (off, false) restores the
    analytic plan."""
    bits = 30000
    analytic = choose_params(bits, bits, sqrt2=True)
    forced = analytic.depth + 1
    cache_file.write_text(json.dumps(
        {"cpu": {tune._key("flagship", bits, bits): {"depth": forced}}}))
    picked = tmul._select_plan(bits, bits, "flagship", "cpu")
    assert picked.depth == forced and picked == plan_for_depth(bits, bits, forced, True)
    seen = []
    real = tmul._driver
    monkeypatch.setattr(tmul, "_driver", lambda k, p: seen.append(p) or real(k, p))
    rnd = random.Random(7)
    a, b = rnd.getrandbits(bits) | 1 << (bits - 1), rnd.getrandbits(bits) | 1 << (bits - 1)
    assert tmul.mul(a, b, device="cpu") == a * b
    assert tmul.sqr(a, device="cpu") == a * a
    assert seen == [picked]
    # mul_many keeps the analytic plan: there are no batch-class entries
    seen.clear()
    assert tmul.mul_many([(a, b), (b, a)], device="cpu") == [a * b, a * b]
    assert seen == [analytic]
    monkeypatch.setenv("MPIR_FFT_TUNE", off)
    assert tmul._select_plan(bits, bits, "flagship", "cpu") == analytic


def _fake_results(monkeypatch, timings):
    """measure_plans replaced by fixed (median, spread) per depth offset
    from the analytic plan's depth."""
    def fake(kind, plans, base, reps, device):
        return {(p.depth, p.w): timings.get(p.depth - base.depth, "oom") for p in plans}
    monkeypatch.setattr(tune, "measure_plans", fake)


@pytest.mark.parametrize("timings,kept", [
    ({0: (10.0, 0.5), 1: (9.7, 0.5), -1: (12.0, 0.1)}, 0),     # a tie within the spread
    ({0: (10.0, 0.05), 1: (9.9, 0.05), -1: (9.85, 0.02)}, 0),  # beyond the spreads, under 2%
    ({0: (10.0, 0.5), 1: (9.4, 1.0), -1: (12.0, 0.1)}, 0),     # within the candidate's spread
    ({0: (10.0, 0.3), 1: (8.0, 0.3), 2: (7.5, 0.2), -1: (9.0, 0.1)}, 2),   # the fastest past it
])
def test_noise_gate(timings, kept, cache_file, monkeypatch):
    bits = 10**7
    _fake_results(monkeypatch, timings)
    base = choose_params(bits, bits, True)
    entry = tune.tune(bits, bits, "flagship", reps=5, device="cpu")
    assert (entry["depth"], entry["analytic"]) == (base.depth + kept, [base.depth, base.w])
    assert entry["ms"] == timings[kept][0]
    assert entry["reps"] == 5 and entry["device"] == "cpu"
    cands = {d - base.depth: rest for d, w, *rest in entry["candidates"]}
    assert cands == {k: list(timings[k]) if k in timings else ["oom"] for k in cands}
    saved = json.loads(cache_file.read_text())["cpu"][tune._key("flagship", bits, bits)]
    assert saved == entry
    assert tune.cached_plan(bits, bits, "flagship", "cpu").depth == base.depth + kept


def test_tuned_plan_reads_cache_first(cache_file, monkeypatch):
    bits = 10**7
    _fake_results(monkeypatch, {0: (10.0, 0.1), 1: (5.0, 0.1)})
    base = choose_params(bits, bits, True)
    assert tune.tuned_plan(bits, bits, device="cpu").depth == base.depth + 1

    def refuse(*args):
        raise AssertionError("measured although the cache holds the size")

    monkeypatch.setattr(tune, "measure_plans", refuse)
    assert tune.tuned_plan(bits, bits, device="cpu").depth == base.depth + 1


def _wrap_driver(monkeypatch, depth, make):
    """models.mul._driver with the candidate at `depth` replaced by make(real run)."""
    real = tmul._driver

    def driver(kind, plan):
        return make(real(kind, plan)) if plan.depth == depth else real(kind, plan)

    monkeypatch.setattr(tmul, "_driver", driver)


def test_measured_tune_on_cpu_keeps_every_candidate_exact(cache_file):
    bits = 20000
    entry = tune.tune(bits, bits, "flagship", reps=2, device="cpu")
    plans = tune.candidate_plans(bits, bits, True)
    assert [c[:2] for c in entry["candidates"]] == [[p.depth, p.w] for p in plans]
    for _, _, median, spread in entry["candidates"]:
        assert median > 0 and spread >= 0
    assert tmul._select_plan(bits, bits, "flagship", "cpu").depth == entry["depth"]


def test_candidate_oom_and_refusal_are_skipped(cache_file, monkeypatch):
    bits = 20000
    base = choose_params(bits, bits, True)

    def oom(run):
        def go(da, db):
            raise torch.OutOfMemoryError("out of memory")
        return go

    _wrap_driver(monkeypatch, base.depth + 1, oom)
    real = tmul._driver

    def refusing(kind, plan):
        if plan.depth == base.depth - 1:
            raise ValueError("plan exceeds the in-HBM staged pipeline's capacity")
        return real(kind, plan)

    monkeypatch.setattr(tmul, "_driver", refusing)
    entry = tune.tune(bits, bits, "flagship", reps=1, device="cpu")
    cands = {d: rest for d, w, *rest in entry["candidates"]}
    assert cands[base.depth + 1] == ["oom"] and cands[base.depth - 1] == ["refused"]
    assert len(cands[base.depth]) == 2


def test_candidate_fault_propagates(cache_file, monkeypatch):
    """A failure other than the plan-time refusals and out-of-memory (a
    kernel that does not build or launch) is not skipped."""
    bits = 20000
    base = choose_params(bits, bits, True)

    def broken(run):
        def go(da, db):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return go

    _wrap_driver(monkeypatch, base.depth + 1, broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tune.tune(bits, bits, "flagship", reps=1, device="cpu")
    assert not cache_file.exists()


def test_candidate_wrong_product_raises(cache_file, monkeypatch):
    bits = 20000
    base = choose_params(bits, bits, True)

    def off_by_one(run):
        def go(da, db):
            out = run(da, db).clone()
            out[0] ^= 1
            return out
        return go

    _wrap_driver(monkeypatch, base.depth - 1, off_by_one)
    with pytest.raises(RuntimeError, match="differs from the analytic plan's"):
        tune.tune(bits, bits, "flagship", reps=1, device="cpu")


def test_same_product_over_common_length():
    t = torch.tensor
    assert tune._same_product(t([1, 2, 0, 0]), t([1, 2, 0]))
    assert not tune._same_product(t([1, 2, 0, 1]), t([1, 2, 0]))
    assert not tune._same_product(t([1, 2, 0]), t([1, 3, 0, 0]))
    assert not tune._same_product(t([1, -1, 0]), t([1, -1, 0]))     # not canonical
    assert not tune._same_product(t([1, 65536]), t([1, 65536]))


def test_jax_reference_params_unchanged():
    """The reference's planner, which the parity above reads, is the one
    the port's copy is pinned to."""
    for bits in (20000, 10**7, 10**9):
        assert _triples([choose_params(bits, bits, True)]) == _triples(
            [jparams.choose_params(bits, bits, True)])
