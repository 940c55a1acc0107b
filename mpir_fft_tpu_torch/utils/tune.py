"""Measured plans for the card (counterpart of mpir_fft_tpu/utils/tune.py).

The analytic planner (utils/params.choose_params) picks (depth, w) from a
work model.  `tune` times the candidate plans around it (depth -2..+2,
`candidate_plans`) on the route mul() takes for each -- out of core,
staged or whole (models.mul._driver) -- on one fixed-seed operand pair
resident on the device, and records the winner; `cached_plan` is the
lookup models.mul._select_plan makes on every call.

Every candidate's product is compared once with the analytic plan's before
its times count: a mismatch raises (a port fault, never a skipped
candidate).  Skipped are only what the reference's plan checks refuse (the
AssertionError of plan_for_depth, the ValueError of
models.mul._require_huge_servable) and out-of-memory, which the entry
records as "oom".  Any other failure propagates: candidate plans give the
kernels (depth, w, L) combinations that the default plans never do.

The noise gate (the reference pins the fastest mean, tune.py:190-206):
the candidates run interleaved, one call each per round over `reps`
rounds, each timed alone (CUDA events on the card, the host clock on the
CPU); a candidate replaces the analytic plan only where its median is
lower by more than both plans' spreads (max - min) and by at least
GATE_MIN_GAIN of the analytic median.  Otherwise the entry keeps the
analytic plan.

Cache: {device tag: {key: entry}} in `<repo>/.cache/tune_cache_torch.json`
(git-ignored) or the file MPIR_FFT_TUNE_CACHE names; a legacy flat {key:
entry} file counts as measured on the device that reads it.  The device
tag is the card's name (torch.cuda.get_device_name) or "cpu", so an entry
governs only the kind of device that measured it.  The reference's
committed `.tune_cache.json` holds TPU entries and is never read, and no
seed for the card is committed: on a fresh tree mul() takes the analytic
plans.  MPIR_FFT_TUNE=0 (or off / false) turns the lookup off.

Keys are "driver:bucket_a:bucket_b" (log-1.4 size buckets), as the
reference's single-product keys.  Its batch-class keys are dropped: the
reference never writes one, so its batched lookup always answers None
(tune.py:167); the port's mul_many takes the analytic plan, as the
reference's does in effect."""

from __future__ import annotations

import json
import math
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS
from mpir_fft_tpu_torch.utils.params import MulPlan, cdiv, choose_params, plan_for_depth

SEED = 42
# the least gain, as a share of the analytic plan's median, that a
# candidate must show beyond both spreads to replace it
GATE_MIN_GAIN = 0.02


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cache_path() -> str:
    return os.environ.get("MPIR_FFT_TUNE_CACHE",
                          os.path.join(_repo_root(), ".cache", "tune_cache_torch.json"))


def _device_tag(device) -> str:
    """The name entries are kept under: the card's name, or "cpu"."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def _bucket(bits: int) -> int:
    """Geometric size bucket: one tuning result serves ~+/-20% sizes."""
    return round(math.log(max(bits, 1), 1.4))


def _key(driver: str, bits_a: int, bits_b: int) -> str:
    return f"{driver}:{_bucket(bits_a)}:{_bucket(bits_b)}"


def _read_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def _is_flat(raw: dict) -> bool:
    return any(isinstance(v, dict) and "depth" in v for v in raw.values())


def _load_cache(device) -> dict:
    """The entries of the local cache file for this device."""
    raw = _read_json(_cache_path())
    return dict(raw if _is_flat(raw) else raw.get(_device_tag(device), {}))


def _save_entry(key: str, entry: dict, device) -> None:
    """Record one tuning result under this device in the local cache file
    (written whole to a temporary file, then renamed over it)."""
    path = _cache_path()
    tag = _device_tag(device)
    raw = _read_json(path)
    if _is_flat(raw):
        raw = {tag: raw}
    raw.setdefault(tag, {})[key] = entry
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".json", dir=os.path.dirname(os.path.abspath(path)))
    with os.fdopen(fd, "w") as f:
        json.dump(raw, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def candidate_plans(bits_a: int, bits_b: int, sqrt2: bool) -> list[MulPlan]:
    base = choose_params(bits_a, bits_b, sqrt2)
    plans = {}
    for d in range(max(2, base.depth - 2), base.depth + 3):
        try:
            p = plan_for_depth(bits_a, bits_b, d, sqrt2)
            plans[(p.depth, p.w)] = p
        except AssertionError:
            continue
    return list(plans.values())


def cached_plan(bits_a: int, bits_b: int, driver: str = "flagship",
                device="cuda") -> MulPlan | None:
    """The plan of this device's cache entry for the size bucket, or None.
    Never measures: models.mul._select_plan consults it on every call."""
    from mpir_fft_tpu_torch.models.mul import DRIVERS

    entry = _load_cache(device).get(_key(driver, bits_a, bits_b))
    if entry is None:
        return None
    try:
        return plan_for_depth(bits_a, bits_b, entry["depth"], DRIVERS[driver][1])
    except AssertionError:
        return None


def _random_digits(rng: np.random.Generator, bits: int) -> np.ndarray:
    """The digits of a random bits-bit integer, top bit set."""
    d = rng.integers(0, 1 << DIGIT_BITS, cdiv(bits, DIGIT_BITS), dtype=np.int32)
    top = (bits - 1) % DIGIT_BITS
    d[-1] = (d[-1] & ((1 << top) - 1)) | (1 << top)
    return d


def timed_ms(fn, device: torch.device) -> tuple[object, float]:
    """(fn(), its ms): CUDA events and a sync on the card, else the host clock."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t) * 1e3


def _same_product(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal canonical digits over the common length, zeros above it."""
    n = min(got.shape[-1], want.shape[-1])
    canonical = all(bool(((x >= 0) & (x < 1 << DIGIT_BITS)).all()) for x in (got, want))
    return (canonical and torch.equal(got[..., :n], want[..., :n])
            and not bool(got[..., n:].any()) and not bool(want[..., n:].any()))


def measure_plans(kind: str, plans: list[MulPlan], base: MulPlan, reps: int = 3,
                  device="cuda") -> dict:
    """Time each plan of `plans` on mul()'s route for driver `kind`, on one
    fixed-seed operand pair of base's sizes on `device`: one checked
    warm-up call each (its product equal to the analytic plan `base`'s),
    then `reps` rounds of one call each, interleaved.  Returns (depth, w)
    -> (median ms, spread ms), or "refused" (the reference refuses the plan)
    or "oom"."""
    from mpir_fft_tpu_torch.models.mul import _driver

    dev = torch.device(device)
    rng = np.random.default_rng(SEED)
    da = torch.from_numpy(_random_digits(rng, base.bits_a)).to(dev)
    db = torch.from_numpy(_random_digits(rng, base.bits_b)).to(dev)
    want = _driver(kind, base)(da, db)
    results, runs = {}, {}
    for p in plans:
        key = (p.depth, p.w)
        try:
            run = _driver(kind, p)
        except ValueError:      # _require_huge_servable: a plan the reference refuses
            results[key] = "refused"
            continue
        oom = False
        try:
            same = _same_product(run(da, db), want)
        except torch.cuda.OutOfMemoryError:
            oom = True
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if oom:
            results[key] = "oom"
            continue
        if not same:
            raise RuntimeError(f"tune: the {kind} product at depth {p.depth}, w {p.w} differs "
                               f"from the analytic plan's (depth {base.depth}, w {base.w})")
        runs[key] = run
    times = {key: [] for key in runs}
    for _ in range(reps):
        for key in list(runs):
            try:
                _, ms = timed_ms(lambda: runs[key](da, db), dev)
            except torch.cuda.OutOfMemoryError:
                ms = None
            if ms is None:
                del runs[key], times[key]
                results[key] = "oom"
                torch.cuda.empty_cache()
            else:
                times[key].append(ms)
    for key, ts in times.items():
        results[key] = (statistics.median(ts), max(ts) - min(ts))
    return {(p.depth, p.w): results[(p.depth, p.w)] for p in plans}


def gate(base_key: tuple, results: dict) -> tuple:
    """The (depth, w) to keep: the fastest candidate whose median beats the
    analytic plan's by more than both spreads and by GATE_MIN_GAIN, else
    the analytic plan's."""
    m0, s0 = results[base_key]
    best = base_key
    for key, r in results.items():
        if key == base_key or not isinstance(r, tuple):
            continue
        m, s = r
        gain = m0 - m
        if gain > max(s0, s) and gain >= GATE_MIN_GAIN * m0 and m < results[best][0]:
            best = key
    return best


def tune(bits_a: int, bits_b: int, driver: str = "flagship", reps: int = 3,
         device="cuda", save: bool = True) -> dict:
    """Measure the candidate plans of a size on `device`, keep the winner
    past the noise gate, record it in the cache (save) and return the
    entry: depth and w kept, their median ms, the analytic (depth, w),
    every candidate as [depth, w, median ms, spread ms] or [depth, w,
    "oom" | "refused"], reps and the device's name."""
    from mpir_fft_tpu_torch.models.mul import DRIVERS

    if reps < 1:
        raise ValueError("tune: reps must be at least 1")
    sqrt2 = DRIVERS[driver][1]
    base = choose_params(bits_a, bits_b, sqrt2)
    plans = candidate_plans(bits_a, bits_b, sqrt2)
    base_key = (base.depth, base.w)
    if base_key not in {(p.depth, p.w) for p in plans}:
        plans.insert(0, base)
    results = measure_plans(driver, plans, base, reps, device)
    win = gate(base_key, results)
    entry = {"depth": win[0], "w": win[1], "ms": results[win][0],
             "analytic": list(base_key),
             "candidates": [[d, w, *r] if isinstance(r, tuple) else [d, w, r]
                            for (d, w), r in results.items()],
             "reps": reps, "device": _device_tag(device)}
    if save:
        _save_entry(_key(driver, bits_a, bits_b), entry, device)
    return entry


def tuned_plan(bits_a: int, bits_b: int, driver: str = "flagship", reps: int = 3,
               use_cache: bool = True, device="cuda") -> MulPlan:
    """The best measured plan for this size and driver on `device`: the
    cached one, else measured now (and cached, with use_cache)."""
    from mpir_fft_tpu_torch.models.mul import DRIVERS

    if use_cache:
        plan = cached_plan(bits_a, bits_b, driver, device)
        if plan is not None:
            return plan
    entry = tune(bits_a, bits_b, driver, reps, device, save=use_cache)
    return plan_for_depth(bits_a, bits_b, entry["depth"], DRIVERS[driver][1])
