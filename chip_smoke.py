#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mpir_fft_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit; fails without a CUDA device.
2. Builds the kernels from csrc/ (nvcc, sm_90a) and prints the build time.
3. Holds each kernel against its plain torch version on the card, at the
   shapes of the 2x10^7-bit plan (depth 12, w 2, L 512, conv 16384): every
   ladder group of the forward (both operands stacked) and inverse
   transforms, the pointwise conv on (16384, 512), normmod_div on
   (16384, 512), canonicalize on the 2.5 M-digit product.  Canonical
   outputs must be equal; redundant outputs equal after normmod and inside
   the ~2^17 digit bound.  Times each (CUDA events, warmed up, median).
4. Drives the main path with the launch counters reset: mul and sqr at
   2x10^6 bits (full compare with Python's a*b), at 2x10^7 bits (residues
   mod four 61-bit primes), timing the end-to-end calls.  Every kernel must
   have launched.
5. Prints the kernel table as one JSON line, the card's line again, and
   the result line {"ok": true, "device": {...}} last.

Any failure raises and exits nonzero before the result line."""

from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys
import time

SEED = 20261016
PLAN_BITS = 20_000_000
SMALL_BITS = 2_000_000


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of fn() over reps runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int) -> float:
    """Median host-clock time of fn() (which ends in a host copy)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def is_canonical(t) -> bool:
    """Every row has digits in [0, 2^16), or is the -1 form [-1, 0, ...]."""
    plain = ((t >= 0) & (t < 1 << 16)).all(dim=-1)
    minus_one = (t[..., 0] == -1) & (t[..., 1:] == 0).all(dim=-1)
    return bool((plain | minus_one).all())


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d, r = d // 2, r + 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):   # deterministic < 3.3e24
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def primes_61(count: int) -> list[int]:
    out, n = [], (1 << 61) - 1
    while len(out) < count:
        if is_prime(n):
            out.append(n)
        n -= 2
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device")
    card = gpu_line()
    print(f"gpu: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from mpir_fft_tpu_torch import kernels
    from mpir_fft_tpu_torch.models.mul import (
        mpn_mul_flagship, mpn_sqr_flagship, mul, out_len_digits, sqr)
    from mpir_fft_tpu_torch.ops.fused import (
        canonicalize_plain_torch, fused_butterfly_ladder, fused_canonicalize_plain,
        fused_normmod_div, ladder_plain, normmod_rows_plain)
    from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, digits_from_int
    from mpir_fft_tpu_torch.ops.pointwise import conv_base_plain
    from mpir_fft_tpu_torch.ops.pointwise_fused import mulmod_base_fused
    from mpir_fft_tpu_torch.ops.transforms import ladder_groups
    from mpir_fft_tpu_torch.utils.params import cdiv, choose_params

    dev = torch.device("cuda", 0)

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {so.name}")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 3. each kernel against its plain version at the plan's shapes ---------
    plan = choose_params(PLAN_BITS, PLAN_BITS, sqrt2=True)
    C, W, L = plan.conv_len, plan.W, plan.W // DIGIT_BITS
    print(f"plan: {plan} L={L} conv={C}")
    assert (plan.depth, plan.w, L, C) == (12, 2, 512, 16384), plan
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    def canon(x):   # normmod through the plain version: independent of the kernels
        return normmod_rows_plain(x.reshape(-1, x.shape[-1]), 0, DIGIT_BITS * x.shape[-1])

    rows = []

    # ladder: every group of the forward (stacked operands) and inverse transform
    lad_ms = lad_plain_ms = 0.0
    lad_err = 0
    w_half = plan.w // 2
    for kind, lead in (("fwd", 2), ("inv", 1)):
        for l, kg in ladder_groups(C, L, kind):
            K = 1 << kg
            shape = (lead << l, K, C >> (l + kg), L)
            steps = tuple(w_half << (l + j) for j in range(kg))
            x = rand(shape, -(1 << 17), 1 << 17)
            got = fused_butterfly_ladder(kind, x, steps, W)
            want = ladder_plain(kind, x, steps, W)
            torch.cuda.synchronize()
            bound = int(got.abs().max())
            err = int((canon(got) - canon(want)).abs().max())
            same = bool(torch.equal(got, want))
            assert err == 0, (kind, shape, err)
            assert bound < 1 << 17, (kind, shape, bound)
            ms = time_ms(lambda: fused_butterfly_ladder(kind, x, steps, W), 10, 2)
            pms = time_ms(lambda: ladder_plain(kind, x, steps, W), 3)
            lad_ms += ms
            lad_plain_ms += pms
            lad_err = max(lad_err, err)
            print(f"ladder {kind} {shape}: max|digit| {bound}, equal after normmod, "
                  f"raw digits identical: {same}; {ms:.3f} ms (plain {pms:.3f} ms)")
    rows.append(dict(name="ladder", source="mpir_fft_tpu_torch/csrc/ladder.cu",
                     replaces="mpir_fft_tpu/ops/fused.py:250", max_abs_err=lad_err,
                     ms=lad_ms, plain_ms=lad_plain_ms))

    # pointwise schoolbook conv on the pointwise batch
    a = rand((C, L), -(1 << 17), 1 << 17)
    b = rand((C, L), -(1 << 17), 1 << 17)
    got = mulmod_base_fused(a, b)
    want = conv_base_plain(a, b)
    err = int((canon(got) - canon(want)).abs().max())
    bound = int(got.abs().max())
    assert err == 0 and bound < 1 << 17, (err, bound)
    ms = time_ms(lambda: mulmod_base_fused(a, b), 10, 2)
    pms = time_ms(lambda: conv_base_plain(a, b), 2)
    print(f"conv_base {tuple(a.shape)}: max|digit| {bound}, equal after normmod; "
          f"{ms:.3f} ms (plain {pms:.3f} ms)")
    rows.append(dict(name="conv_base", source="mpir_fft_tpu_torch/csrc/conv_base.cu",
                     replaces="mpir_fft_tpu/ops/pointwise_fused.py:77", max_abs_err=err,
                     ms=ms, plain_ms=pms))

    # normmod_div tail, with the ripple edge rows
    x = rand((C, L), -(1 << 18), 1 << 18)
    x[0] = 0xFFFF
    x[1] = 0
    x[2] = 0
    x[2, 0] = -1
    x[3] = 0
    x[3, L - 1] = 1 << 16       # carry out of the top: folds in as -1
    s = (2 * W - plan.lg_conv) % (2 * W)
    got = fused_normmod_div(x, s, W)
    want = normmod_rows_plain(x, s, W)
    err = int((got - want).abs().max())
    assert err == 0, err
    assert is_canonical(got)
    for s_edge in (0, 1, W - 1, W, W + 17, 2 * W - 1):
        assert torch.equal(fused_normmod_div(x[:64], s_edge, W),
                           normmod_rows_plain(x[:64], s_edge, W)), s_edge
    ms = time_ms(lambda: fused_normmod_div(x, s, W), 10, 2)
    pms = time_ms(lambda: normmod_rows_plain(x, s, W), 3)
    print(f"normmod_div {tuple(x.shape)} d={plan.lg_conv}: exact; {ms:.3f} ms (plain {pms:.3f} ms)")
    rows.append(dict(name="normmod", source="mpir_fft_tpu_torch/csrc/normmod.cu",
                     replaces="mpir_fft_tpu/ops/fused.py:503", max_abs_err=err,
                     ms=ms, plain_ms=pms))

    # exact carry of the product's digits
    N = out_len_digits(plan)
    v = rand((N,), 0, 1 << 20)
    v[-2:] = 0
    ripple = torch.full((N,), 0xFFFF, dtype=torch.int32, device=dev)
    ripple[0] = 0x1FFFF
    ripple[-2:] = 0
    err = 0
    for vec in (v, ripple):
        got = fused_canonicalize_plain(vec)
        want = canonicalize_plain_torch(vec)
        err = max(err, int((got - want).abs().max()))
        assert is_canonical(got[None])
    assert err == 0, err
    ms = time_ms(lambda: fused_canonicalize_plain(v), 10, 2)
    pms = time_ms(lambda: canonicalize_plain_torch(v), 3)
    print(f"canonicalize ({N},): exact (random + full-length ripple); "
          f"{ms:.3f} ms (plain {pms:.3f} ms)")
    rows.append(dict(name="canonicalize", source="mpir_fft_tpu_torch/csrc/canonicalize.cu",
                     replaces="mpir_fft_tpu/ops/fused.py:574", max_abs_err=err,
                     ms=ms, plain_ms=pms))

    # -- 4. the main path, counted ---------------------------------------------
    rnd = random.Random(SEED)
    x2 = rnd.getrandbits(SMALL_BITS) | (1 << (SMALL_BITS - 1))
    y2 = rnd.getrandbits(SMALL_BITS) | (1 << (SMALL_BITS - 1))
    a7 = rnd.getrandbits(PLAN_BITS) | (1 << (PLAN_BITS - 1))
    b7 = rnd.getrandbits(PLAN_BITS) | (1 << (PLAN_BITS - 1))
    primes = primes_61(4)
    da7 = torch.from_numpy(digits_from_int(a7, cdiv(PLAN_BITS, DIGIT_BITS))).to(dev)
    db7 = torch.from_numpy(digits_from_int(b7, cdiv(PLAN_BITS, DIGIT_BITS))).to(dev)
    torch.cuda.synchronize()

    kernels.reset_launches()
    prod2 = mul(x2, y2)
    assert prod2 == x2 * y2, "mul at 2e6 bits differs from Python's product"
    assert sqr(x2) == x2 * x2, "sqr at 2e6 bits differs from Python's product"
    print(f"mul/sqr {SMALL_BITS} bits: exact (full compare)")
    prod7 = mul(a7, b7)
    sq7 = sqr(a7)
    for p in primes:
        assert prod7 % p == (a7 % p) * (b7 % p) % p, ("mul residue", p)
        assert sq7 % p == (a7 % p) * (a7 % p) % p, ("sqr residue", p)
    assert prod7.bit_length() in (2 * PLAN_BITS - 1, 2 * PLAN_BITS)
    print(f"mul/sqr {PLAN_BITS} bits: residues mod {len(primes)} 61-bit primes agree")
    e2e = {
        "mul_2e6_ms": wall_ms(lambda: mul(x2, y2), 5),
        "sqr_2e6_ms": wall_ms(lambda: sqr(x2), 5),
        "mul_2e7_ms": wall_ms(lambda: mul(a7, b7), 3),
        "sqr_2e7_ms": wall_ms(lambda: sqr(a7), 3),
        "mul_2e7_device_ms": time_ms(lambda: mpn_mul_flagship(da7, db7, plan), 5),
        "sqr_2e7_device_ms": time_ms(lambda: mpn_sqr_flagship(da7, plan), 5),
    }
    launches = dict(kernels.LAUNCHES)
    print("e2e (mul/sqr: host clock incl. digit conversion; *_device: CUDA events, "
          "digits on the card): " + json.dumps(e2e))
    print(f"launches on the main path: {launches}")
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the main path"

    # -- 5. report ------------------------------------------------------------
    for r in rows:
        r["route"] = "cuda"
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
