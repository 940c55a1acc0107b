"""Where the time of a multiply goes on the card (counterpart, in part, of
mpir_fft_tpu/utils/profile.py).

    python -m mpir_fft_tpu_torch.utils.profile [SIZE ...] [--mulmod LG ...] [--reps R]

For each SIZE -- BITS (both operands BITS bits) or BITS_AxBITS_B (an
unbalanced product, e.g. 1000000000x100000000); operands random from a
fixed seed; default 10^7, 10^8 and 10^9:
  * the plan (its trunc_mfa, and the inner mulmod plan where the pointwise
    recurses);
  * the flagship's device time, digits on the card (CUDA events, median),
    on the route mul() takes (models.mul._driver): out of core where
    flagship_is_huge (past 2^29 elements, e.g. 4x10^9 bits), the staged
    flagship where flagship_is_staged (10^8 bits and up), else
    mpn_mul_flagship;
  * a torch.profiler window over R such calls after a warm-up:
    device time per call by kernel (the port's kernels by name, the NTT's
    int8 GEMMs as "int8_gemm", PyTorch's other ops -- split, stack,
    combine, the sign lift, the truncation recursion's glue -- as "torch
    ops", its five costliest kernels by name beside; the int8 GEMMs by
    cuBLASLt kernel name, with their launches per call), the device kernels
    launched per call, and the device's busy and idle share of the window;
  * the split of one mul() call on the Python ints (after a warm-up call)
    into its steps, read from the program's spans (kernels.span) in a
    torch.profiler window: planner (mul()'s own time outside the spans
    below), digits_from_int of both operands, host-to-device copies, the
    flagship call (the host's time enqueueing it: the route's span), the
    device-to-host copy (the host waits there for the card to finish) and
    int_from_digits;
  * the peak device memory of that mul() call.
With --mulmod LG ... (e.g. 22 24 29), the same for mulmod_int at N = 2^LG,
residues random from the seed: its plan (m, Lp), the device time of
mulmod(canonical=True) on the digits (CUDA events), the profiler window's
kernels (the long-row normmod as "normmod (long)"), the split of one
mulmod_int call from its spans (digits_from_int, host to device, mulmod
enqueued, device to host with the wait, int_from_digits), the host's share of
it outside the card's work, and its peak device memory.
Prints one JSON object per size, then the card's nvidia-smi name and
power-limit line.  Needs a CUDA device; without one it raises."""

from __future__ import annotations

import argparse
import json
import math
import random
import statistics
import subprocess
import time

import numpy as np
import torch

from mpir_fft_tpu_torch import kernels
from mpir_fft_tpu_torch.models.mul import (_driver, _select_plan, driver_stages, flagship_is_huge,
                                           flagship_is_staged, mul)
from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, Ring, digits_from_int
from mpir_fft_tpu_torch.ops.mfa import fft_radix2_mfa, ifft_radix2_mfa
from mpir_fft_tpu_torch.ops.mulmod import inner_plan, mulmod, mulmod_int, mulmod_plan
from mpir_fft_tpu_torch.ops.negacyclic import fft_negacyclic, ifft_negacyclic
from mpir_fft_tpu_torch.ops.ntt import gemm_ops, ntt_supported
from mpir_fft_tpu_torch.ops.pointwise import _use_ntt, base_serves
from mpir_fft_tpu_torch.ops.sqrt2 import fft_sqrt2, ifft_sqrt2
from mpir_fft_tpu_torch.ops.transforms import fft_radix2, ifft_radix2
from mpir_fft_tpu_torch.utils.params import cdiv
from mpir_fft_tpu_torch.utils.tune import timed_ms

SEED = 20261016

# the least time the card could take (H100 SXM, NVIDIA data sheet and
# Hopper white paper): HBM3 at 3.35 TB/s; 64 INT32 lanes per SM x 132 SMs x
# 1.98 GHz boost = 16.7 x 10^12 int32 operations (multiply-adds) per second;
# dense int8 tensor cores 1979 x 10^12 operations per second
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
INT8_OPS_PER_S = 1979e12
# 64 FP64 lanes per SM: the same 16.7 x 10^12 fused multiply-adds per second
FP64_FMA_PER_S = 64 * 132 * 1.98e9


def bound(nbytes: float, ops: float, ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    """(least time in ms, what bounds it) for nbytes moved and ops done."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# device kernel name fragment -> the port's kernel (csrc/); the rest are
# PyTorch's own kernels
KERNEL_NAMES = (
    # the ladder's launches with a last-stage table (ladder_pe) or a
    # pre_half twiddle run the same kernel, so the profile counts them under
    # "ladder"; the Garner kernels' post form runs its own kernel
    ("garner_post_kernel", "garner_post"),
    ("ladder_kernel", "ladder"), ("mfa_cols_kernel", "mfa_cols"),
    ("conv_short_kernel", "conv_base"), ("conv_block_kernel", "conv_base"),
    ("normmod_short_kernel", "normmod"), ("normmod_block_kernel", "normmod"),
    # the long route's three kernels (the chained scan, its fold, the reset)
    ("normmod_", "normmod (long)"), ("canon_", "canonicalize"),
    ("twiddle_half_kernel", "twiddle_half"), ("sqrt2_top_fwd", "sqrt2_top_fwd"),
    ("sqrt2_top_inv", "sqrt2_top_inv"), ("transform_small", "transform_small"),
    ("ntt4_input_planes_kernel", "ntt4_input_planes"),
    ("ntt4_fwd_twiddle_kernel", "ntt4_fwd_twiddle"), ("ntt4_pointwise_kernel", "ntt4_pointwise"),
    ("ntt4_inv_twiddle_kernel", "ntt4_inv_twiddle"), ("ntt4_residues_kernel", "ntt4_residues"),
    ("ntt4_fused_kernel", "ntt4_fused"), ("garner_residues_kernel", "garner_residues"),
    ("pair_input_planes_kernel", "pair_input_planes"),
    ("garner_pair_carry_kernel", "garner_pair_carry"),
    ("input_planes_kernel", "input_planes"), ("mid_planes_kernel", "mid_planes"),
    ("garner_carry_kernel", "garner_carry"),
    # torch._int_mm's cuBLASLt kernels (the NTT's transform GEMMs)
    ("gemm", "int8_gemm"), ("imma", "int8_gemm"),
)


def _kernel_of(name: str) -> str:
    for frag, kernel in KERNEL_NAMES:
        if frag in name:
            return kernel
    return "torch ops"


def _events_ms(fn, reps: int) -> float:
    """Median device ms of fn() over reps calls (CUDA events)."""
    return statistics.median(timed_ms(fn, torch.device("cuda"))[1] for _ in range(reps))


def device_kernels_per_call(fn, reps: int = 1) -> float:
    """Device kernels that fn() launches per call (torch.profiler over reps
    calls after one warm-up), PyTorch's own ops and copies included."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / reps


# the host steps of mul() / mulmod_int(): key -> the span it is read from
HOST_STEPS = {"digits_from_int x2": "mf.digits_from_int", "host to device": "mf.h2d",
              "device to host": "mf.d2h", "int_from_digits": "mf.int_from_digits"}


def span_ms(prof) -> dict[str, float]:
    """Host ms of a finished torch.profiler window's mf.* spans, summed by
    name over the spans no span of the same name encloses (a recursive
    mulmod's inner rings count once, inside the outer call)."""
    out: dict[str, float] = {}
    ends: dict[str, int] = {}
    evs = sorted((ev for ev in prof.profiler.kineto_results.events()
                  if ev.name().startswith("mf.")), key=lambda ev: ev.start_ns())
    for ev in evs:
        name, start = ev.name(), ev.start_ns()
        if start < ends.get(name, -1):
            continue
        ends[name] = start + ev.duration_ns()
        out[name] = out.get(name, 0.0) + ev.duration_ns() / 1e6
    return out


def host_steps(call, outer: str, route: str, label: str, device="cuda") -> tuple[dict, int]:
    """The steps of one call() (mul() or mulmod_int() on Python ints) after a
    warm-up call, in host ms from the program's spans: HOST_STEPS, `label`
    from the span `route` (the host's time enqueueing the route), and, where
    label is "flagship", "planner": the span `outer` less all of them.
    Returns them and the call's peak device memory (bytes; 0 off the card)."""
    on_card = torch.device(device).type == "cuda"
    call()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    ms = span_ms(prof)
    steps = {k: ms.get(name, 0.0) for k, name in HOST_STEPS.items()}
    steps[label] = ms.get(route, 0.0)
    if label == "flagship":
        steps = {"planner": ms[outer] - sum(steps.values()), **steps}
    return steps, peak


def random_operand(rnd: random.Random, bits: int) -> int:
    """A random bits-bit int from rnd, top bit set (getrandbits takes a C
    int: from 2^31 bits, 2^30 bits at a time)."""
    if bits < 1 << 31:
        return rnd.getrandbits(bits) | (1 << (bits - 1))
    n, top = cdiv(bits, 8), (bits - 1) % 8
    buf = bytearray(b"".join(rnd.getrandbits(1 << 30).to_bytes(1 << 27, "little")
                             for _ in range(cdiv(bits, 1 << 30)))[:n])
    buf[-1] = (buf[-1] & ((1 << top) - 1)) | (1 << top)
    return int.from_bytes(buf, "little")


def profile_size(bits_a: int, bits_b: int, reps: int) -> dict:
    rnd = random.Random(SEED + bits_a + bits_b)
    a, b = random_operand(rnd, bits_a), random_operand(rnd, bits_b)

    plan = _select_plan(bits_a, bits_b, "flagship", "cuda")
    run = _driver("flagship", plan)
    route = "mf.huge" if flagship_is_huge(plan) else "mf.flagship"
    steps, peak = host_steps(lambda: mul(a, b), "mf.mul", route, "flagship")
    da = torch.from_numpy(digits_from_int(a, cdiv(bits_a, DIGIT_BITS))).cuda()
    db = torch.from_numpy(digits_from_int(b, cdiv(bits_b, DIGIT_BITS))).cuda()
    W = plan.W
    inner = inner_plan(W)
    return {
        "bits": [bits_a, bits_b],
        "plan": {"depth": plan.depth, "w": plan.w, "L": W // DIGIT_BITS,
                 "conv": plan.conv_len, "trunc_mfa": plan.trunc_mfa},
        "inner": None if inner is None else {"m": inner.m, "Lp": inner.Lp, "wp": inner.wp},
        "route": ("out of core" if flagship_is_huge(plan) else
                  "staged" if flagship_is_staged(plan) else "whole"),
        "device_ms": _events_ms(lambda: run(da, db), reps),
        **_window(lambda: run(da, db), reps),
        "mul_host_steps_ms": steps,
        "peak_memory_gib": peak / 2**30,
    }


def profile_mulmod(lg: int, reps: int) -> dict:
    """mulmod_int at N = 2^lg: as profile_size, on mulmod(canonical=True)."""
    N = 1 << lg
    rnd = random.Random(SEED + N)
    a, b = rnd.randrange((1 << N) + 1), rnd.randrange((1 << N) + 1)
    L = N // DIGIT_BITS
    run = lambda x, y: mulmod(x, y, N, canonical=True)   # noqa: E731
    steps, peak = host_steps(lambda: mulmod_int(a, b, N), "mf.mulmod_int", "mf.mulmod",
                             "mulmod")
    da = torch.from_numpy(digits_from_int(a if a < (1 << N) else -1, L)).cuda()
    db = torch.from_numpy(digits_from_int(b if b < (1 << N) else -1, L)).cuda()
    plan = mulmod_plan(N)
    return {
        "mulmod_N": N,
        "plan": {"m": plan.m, "Lp": plan.Lp, "wp": plan.wp, "b": plan.b},
        "device_ms": _events_ms(lambda: run(da, db), reps),
        **_window(lambda: run(da, db), reps),
        "mulmod_int_host_steps_ms": steps,
        # outside the card's work: neither enqueueing mulmod nor waiting for it
        "host_share": 1.0 - (steps["mulmod"] + steps["device to host"]) / sum(steps.values()),
        "peak_memory_gib": peak / 2**30,
    }


def _window(fn, reps: int) -> dict:
    """A torch.profiler window over reps fn() calls: device ms per call by
    kernel, kernels per call, the device's busy and idle share."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t) * 1e3
    by_kernel: dict[str, float] = {}
    torch_ops: dict[str, float] = {}
    gemms: dict[str, tuple[float, float]] = {}
    launches = 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = _kernel_of(ev.key)
            ms = ev.device_time_total / 1e3 / reps
            by_kernel[k] = by_kernel.get(k, 0.0) + ms
            launches += ev.count
            if k == "torch ops":
                torch_ops[ev.key[:60]] = torch_ops.get(ev.key[:60], 0.0) + ms
            elif k == "int8_gemm":
                ms0, n0 = gemms.get(ev.key[:80], (0.0, 0.0))
                gemms[ev.key[:80]] = (ms0 + ms, n0 + ev.count / reps)
    busy = sum(by_kernel.values())
    return {
        "profiled_wall_ms_per_call": window_ms / reps,
        "device_busy_ms_per_call": busy,
        "device_idle_share": max(0.0, 1.0 - busy * reps / window_ms),
        "device_ms_by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])),
        "device_kernels_per_call": launches / reps,
        "torch_ops_top5_ms": dict(sorted(torch_ops.items(), key=lambda kv: -kv[1])[:5]),
        "int8_gemm_kernels_ms_and_launches": gemms,
    }


# ---------------------------------------------------------------------------
# The stage profile (the reference's profile.py:77-304)
# ---------------------------------------------------------------------------

def _stage_fns(plan, driver: str):
    """(fwd, pw, inv, norm or None, combine, meta) of `driver` at `plan`:
    the stages the driver itself runs (models.mul.driver_stages), the
    split folded into the forward.  The staged flagship's pw overwrites its
    first argument's rows in place.  meta: whether the route is staged,
    the rows the pointwise multiplies and whether it recurses."""
    s = driver_stages(driver, plan)
    rows = {"flagship": plan.trunc_mfa, "mfa_trunc": plan.trunc_mfa, "trunc": plan.trunc,
            "trunc_sqrt2": plan.trunc}.get(driver, plan.conv_len)
    meta = {"staged": driver == "flagship" and flagship_is_staged(plan),
            "pointwise_rows": rows, "recursive": driver == "flagship"}
    return (lambda d: s.fwd(s.split(d))), s.pw, s.inv, s.norm, s.combine, meta


def pointwise_gemm_ops(rows: int, W: int, recursive: bool) -> int:
    """int8 GEMM operations of the pointwise of `rows` products mod 2^W+1
    as models.mul._pointwise routes it: the NTT leaf's (ops/ntt.gemm_ops)
    where it serves the ring, the recursion's inner rings
    (ops/mulmod.inner_plan) where the pointwise recurses, none on the
    schoolbook; under MPIR_FFT_NTT_PAIR=1 the pair tier's where it serves
    the ring (gemm_ops reads the variable)."""
    L = W // DIGIT_BITS
    inner = None if not recursive and base_serves(L) else inner_plan(W)
    if inner is not None:
        return pointwise_gemm_ops(rows * inner.m, inner.Wp, True)
    return gemm_ops(rows, L) if ntt_supported(L) and _use_ntt() else 0


def _stage_s(fn, args, reps: int, dev: torch.device) -> tuple[float, object]:
    """(median seconds of fn over reps calls after one warm-up, the last
    call's output).  Every call takes fresh copies of args, made outside
    its timed window (the staged pointwise writes its input in place)."""
    times, out = [], None
    for i in range(reps + 1):
        fresh = [a.clone() for a in args]
        out = None
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out, ms = timed_ms(lambda: fn(*fresh), dev)
        del fresh
        if i:
            times.append(ms)
    return statistics.median(times) / 1e3, out


def _device_line(dev: torch.device) -> dict:
    """The device's name (and on the card its nvidia-smi name and power
    limit) and the clock the times come from."""
    if dev.type == "cuda":
        return {"device": torch.cuda.get_device_name(dev), "gpu": gpu_line(),
                "clock": "cuda events"}
    return {"device": dev.type, "clock": "host"}


def _random_digits(rng: np.random.Generator, shape) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 1 << DIGIT_BITS, shape, dtype=np.int32))


def profile_stages(bits: int, reps: int = 8, driver: str = "flagship", device="cuda") -> dict:
    """Each stage of a bits x bits multiply on mul()'s plan and route
    (split + forward of each operand, pointwise, inverse, normalize,
    combine; the reference's keys), timed alone on digits resident on
    `device`, each stage's inputs freed before the next; beside them the
    whole route's time in the same run (route_s), the composed stages'
    product held equal to the route's, the pointwise's int8 GEMM rate
    beside INT8_OPS_PER_S and the forward's ladder bytes a second beside
    HBM_BYTES_PER_S.  The card's times are CUDA events; on the CPU (asked
    for with device="cpu") the host clock, and "clock" says which."""
    from mpir_fft_tpu_torch.utils.ladder_bench import ladder_calls

    dev = torch.device(device)
    plan = _select_plan(bits, bits, driver, dev)
    fwd, pw, inv, norm, combine, meta = _stage_fns(plan, driver)
    rng = np.random.default_rng(0)
    L = cdiv(bits, DIGIT_BITS)
    da, db = _random_digits(rng, L).to(dev), _random_digits(rng, L).to(dev)
    out = {"bits": bits, "driver": driver,
           "plan": {"depth": plan.depth, "w": plan.w, "W": plan.W, "L": plan.W // DIGIT_BITS,
                    "trunc": meta["pointwise_rows"]},
           "staged": meta["staged"], **_device_line(dev)}
    route = _driver(driver, plan)
    out["route_s"], want = _stage_s(route, (da, db), reps, dev)
    with ladder_calls() as seen:
        fwd(da)
    ladder_bytes = sum(n * math.prod(shape) * 8 for (_, shape, *_), (n, *_) in seen.items())
    out["fwd_a_s"], fa = _stage_s(fwd, (da,), reps, dev)
    del da
    out["fwd_b_s"], fb = _stage_s(fwd, (db,), reps, dev)
    del db
    s, prod = _stage_s(pw, (fa, fb), reps, dev)
    out["pointwise_rows_s" if meta["staged"] else "pointwise_s"] = s
    del fa, fb
    out["inverse_s"], c = _stage_s(inv, (prod,), reps, dev)
    del prod
    if norm is not None:            # else the inverse folds the normalize in
        out["normalize_s"], c = _stage_s(norm, (c,), reps, dev)
    out["combine_s"], got = _stage_s(combine, (c,), reps, dev)
    if not torch.equal(got, want):
        raise RuntimeError(f"profile_stages: the composed stages' product differs from the "
                           f"{driver} route's at {bits} bits")
    out["total_s"] = sum(v for k, v in out.items() if k.endswith("_s") and k != "route_s")
    out["stages_over_route"] = out["total_s"] / out["route_s"]
    ops = pointwise_gemm_ops(meta["pointwise_rows"], plan.W, meta["recursive"])
    pw_s = out.get("pointwise_rows_s", out.get("pointwise_s"))
    out.update({"pointwise_gemm_ops": ops, "pointwise_int8_ops_per_second": ops / pw_s,
                "int8_peak_ops_per_second": INT8_OPS_PER_S,
                "pointwise_note": "whole-stage rate: the GEMMs' int8 operations (two a "
                                  "multiply-add) over the stage's time, links included",
                "fwd_ladder_bytes": ladder_bytes, "fwd_ladder_bytes_per_second": ladder_bytes
                / out["fwd_a_s"], "hbm_peak_bytes_per_second": HBM_BYTES_PER_S,
                "fwd_note": "the ladder launches' digits read and written once (8 bytes a "
                            "digit) over one operand's whole forward stage"})
    return out


def profile_transforms(depth: int, w: int, reps: int = 8, batch: int = 1,
                       device="cuda") -> dict:
    """Times of the single transforms at the ring (n = 2^depth, w): the
    flat pair (length 2n), the sqrt2 pair (4n), the MFA pair and the
    negacyclic pair (the reference's time_mfa / time_ifft /
    time_negacyclic harnesses, mul_fft.c:5105-5286); `batch` leading rows
    (the pointwise stage's regime) where batch > 1."""
    dev = torch.device(device)
    ring = Ring(1 << depth, w)
    W, L = ring.bits, ring.L
    C = 2 * ring.n
    n1 = 1 << ((depth + 1) // 2)
    n2 = C // n1
    rng = np.random.default_rng(0)
    lead = (batch,) if batch > 1 else ()
    x2 = _random_digits(rng, lead + (C, L)).to(dev)
    x4 = _random_digits(rng, lead + (2 * C, L)).to(dev)
    xm = _random_digits(rng, lead + (n2, n1, L)).to(dev)
    cases = {
        "fft_radix2": (lambda v: fft_radix2(v, w, W), x2),
        "ifft_radix2": (lambda v: ifft_radix2(v, w, W), x2),
        "fft_sqrt2": (lambda v: fft_sqrt2(v, w, W), x4),
        "ifft_sqrt2": (lambda v: ifft_sqrt2(v, w, W), x4),
        "fft_mfa": (lambda v: fft_radix2_mfa(v, w, W, n1, n2), xm),
        "ifft_mfa": (lambda v: ifft_radix2_mfa(v, w, W, n1, n2), xm),
        "fft_negacyclic": (lambda v: fft_negacyclic(v, w, W), x2),
        "ifft_negacyclic": (lambda v: ifft_negacyclic(v, w, W), x2),
    }
    out = {"depth": depth, "w": w, "W": W, "L": L, "batch": batch, **_device_line(dev)}
    for name, (fn, x) in cases.items():
        out[name + "_s"], _ = _stage_s(fn, (x,), reps, dev)
    return out


def gpu_line() -> str:
    """The card's `nvidia-smi` name and power-limit line."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", help="BITS or BITS_AxBITS_B (default: 10^7, 10^8, "
                    "10^9 where no --mulmod is given; --stages: BITS only)")
    ap.add_argument("--mulmod", nargs="+", type=int, default=[], metavar="LG",
                    help="mulmod_int at N = 2^LG")
    ap.add_argument("--stages", action="store_true",
                    help="the stage profile of each size instead (profile_stages)")
    ap.add_argument("--driver", default="flagship", help="the driver of --stages")
    ap.add_argument("--transforms", action="store_true",
                    help="the single transforms at --depth, --w, --batch (profile_transforms)")
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--w", type=int, default=1)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sizes = args.sizes or ([] if args.mulmod or args.transforms else
                           ["10000000", "100000000", "1000000000"])
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    kernels.lib()                   # build first: no size pays for nvcc
    torch.empty(1, device="cuda")   # nor for creating the CUDA context
    if args.transforms:
        print(json.dumps(profile_transforms(args.depth, args.w, args.reps, args.batch)),
              flush=True)
    for size in sizes:
        bits = [int(v) for v in size.split("x")]
        if args.stages:
            print(json.dumps(profile_stages(bits[0], args.reps, args.driver)), flush=True)
        else:
            print(json.dumps(profile_size(bits[0], bits[-1], args.reps)), flush=True)
    for lg in args.mulmod:
        print(json.dumps(profile_mulmod(lg, args.reps)), flush=True)
    print(gpu_line())


if __name__ == "__main__":
    main()
