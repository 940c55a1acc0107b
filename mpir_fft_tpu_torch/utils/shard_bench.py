"""The sharded products of chip_smoke.py's sharded phase, rank by rank
(parallel/dryrun.run_ranks runs `rank_phase` on every rank).

A spec is (label, route, bits_a, bits_b, depth, pairs):
  route "mul"   parallel.mfa_sharded.sharded_mul_fn(ctx, plan, "flagship")
                at the analytic plan (staged from 10^8 bits), a product
                and, balanced, a square;
  route "many"  sharded_mul_many_fn: `pairs` products, pairs/ndev a rank;
  route "huge"  models/huge.py mul_huge with ctx at plan_for_depth(depth).
Every rank draws the same operand digits from one numpy seed
(`operand_digits`) and checks that all ranks hold the same before it
multiplies.  Each product runs twice: the first run checked (its residues
mod the given primes; rank 0's digits too at up to `full_bits` bits, for
an exact compare), the second timed -- its device ms (CUDA events; the host's
clock on the CPU), the exchanges it ran (count, bytes sent, their
host-clock ms with the device synchronized around each) and the peak
device memory.  The rank's kernel launches over the whole phase come back
with the results, and rank 0's ladder launch shapes in the in-core routes
(utils/ladder_bench ladder_calls), for the caller to time on the card."""

from __future__ import annotations

import numpy as np
import torch

from mpir_fft_tpu_torch import kernels
from mpir_fft_tpu_torch.models.huge import mul_huge
from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS
from mpir_fft_tpu_torch.parallel.mfa_sharded import sharded_mul_fn, sharded_mul_many_fn
from mpir_fft_tpu_torch.utils.interop import tensor_to_digits
from mpir_fft_tpu_torch.utils.ladder_bench import ladder_calls
from mpir_fft_tpu_torch.utils.params import cdiv, choose_params, plan_for_depth
from mpir_fft_tpu_torch.utils.tune import timed_ms


def operand_digits(bits: int, seed: int) -> np.ndarray:
    """A bits-bit operand's canonical digits (top bit set) from seed."""
    L = cdiv(bits, DIGIT_BITS)
    d = np.random.default_rng(seed).integers(0, 1 << DIGIT_BITS, L, dtype=np.int32)
    top = bits - DIGIT_BITS * (L - 1)
    d[-1] = (d[-1] & ((1 << top) - 1)) | (1 << (top - 1))
    return d


def residues(digits: np.ndarray, primes) -> list[int]:
    """The value of canonical digits mod each prime (asserts canonical)."""
    assert digits.min(initial=0) >= 0 and digits.max(initial=0) < 1 << DIGIT_BITS
    v = int.from_bytes(np.ascontiguousarray(digits, dtype="<u2").tobytes(), "little")
    return [v % p for p in primes]


def _same_on_every_rank(ctx, *xs: torch.Tensor) -> None:
    """Assert every rank holds the same operand digits: one all-gather of
    three sums of each (every digit, every other, every third)."""
    sums = torch.stack([torch.stack([y.sum(dtype=torch.int64) for y in
                                     (x.reshape(-1), x.reshape(-1)[::2], x.reshape(-1)[1::3])])
                        for x in xs])
    seen = ctx.gather(sums[None], 0)
    assert bool((seen == seen[0]).all()), "the ranks hold different operands"


def _plan(route: str, bits_a: int, bits_b: int, depth: int | None):
    if route == "huge":
        return plan_for_depth(bits_a, bits_b, depth, sqrt2=True)
    return choose_params(bits_a, bits_b, sqrt2=True)


def _runs(ctx, spec, seed: int):
    """[(name, fn)] of the spec's products on this rank."""
    label, route, ba, bb, depth, pairs = spec
    plan = _plan(route, ba, bb, depth)
    dev = ctx.device
    if route == "many":
        da = torch.stack([torch.from_numpy(operand_digits(ba, seed + 2 * i))
                          for i in range(pairs)]).to(dev)
        db = torch.stack([torch.from_numpy(operand_digits(bb, seed + 2 * i + 1))
                          for i in range(pairs)]).to(dev)
        _same_on_every_rank(ctx, da, db)
        run = sharded_mul_many_fn(ctx, plan, "flagship")
        return plan, [("mul", lambda: run(da, db))]
    da = torch.from_numpy(operand_digits(ba, seed)).to(dev)
    db = torch.from_numpy(operand_digits(bb, seed + 1)).to(dev)
    _same_on_every_rank(ctx, da, db)
    if route == "huge":
        return plan, [("mul", lambda: mul_huge(da, db, plan, ctx))]
    run = sharded_mul_fn(ctx, plan, "flagship")
    out = [("mul", lambda: run(da, db))]
    if ba == bb:
        out.append(("sqr", lambda: run(da)))
    return plan, out


def rank_phase(ctx, specs, seed: int, primes, full_bits: int) -> dict:
    """Every spec's products on this rank: {label: {plan, name: {residues,
    digits (rank 0, at up to full_bits), launches (the checked run's, per
    kernel), device_ms, exchanges, peak_gib}}},
    "launches" (the phase's, per kernel), "ladder" (rank 0: the in-core
    routes' launch shapes, tables as numpy arrays: a process's tensors do not
    outlive it), "transport", "backend", "rank"."""
    kernels.reset_launches()
    out = {"rank": ctx.rank, "transport": ctx.transport, "backend": ctx.backend}
    seen: dict = {}
    for i, spec in enumerate(specs):
        label, route, ba, bb = spec[:4]
        plan, runs = _runs(ctx, spec, seed + 1000 * i)
        rec = out[label] = {"plan": (plan.depth, plan.w, plan.W // DIGIT_BITS, plan.conv_len,
                                     plan.trunc_mfa, plan.n1)}
        for name, fn in runs:
            before = dict(kernels.LAUNCHES)
            if ctx.rank == 0 and route != "huge":
                with ladder_calls() as calls:
                    got = tensor_to_digits(fn())
                for key, (count, steps, W, pe, pre) in calls.items():
                    old = seen.get(key)
                    seen[key] = [count + (old[0] if old else 0), steps, W,
                                 None if pe is None else pe.cpu().numpy(), pre]
            else:
                got = tensor_to_digits(fn())
            rows = got.reshape(-1, got.shape[-1])
            r = rec[name] = {"residues": [residues(row, primes) for row in rows],
                             "launches": {k: n - before[k] for k, n in kernels.LAUNCHES.items()}}
            if ctx.rank == 0 and max(ba, bb) <= full_bits:
                r["digits"] = got
            del got, rows
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
                torch.cuda.reset_peak_memory_stats(ctx.device)
            ctx.reset_stats()
            _, r["device_ms"] = timed_ms(fn, ctx.device)
            r["exchanges"] = dict(ctx.stats)
            if ctx.device.type == "cuda":
                r["peak_gib"] = torch.cuda.max_memory_allocated(ctx.device) / 2**30
    out["launches"] = dict(kernels.LAUNCHES)
    out["ladder"] = seen
    return out
