"""The butterfly ladder and the Garner post leg at the shapes the main path
gives them, on the card: the per-shape measurement chip_smoke.py also runs
(measure_launches, measure_post), and a tool beside utils/profile.py; and
the recorders of the launches and passes it checks (ladder_calls,
huge_passes).

    python -m mpir_fft_tpu_torch.utils.ladder_bench [SIZE ...] [--ntt0 SIZE ...] [--reps R]

For each SIZE (bits, both operands; default 10^8, 10^9 and 2x10^9) on the
default plan, and each --ntt0 SIZE on its MPIR_FFT_NTT=0 plan:
  * the staged flagship (the route mul() takes from 10^8 bits) runs one
    product with the ladder's launches recorded (ladder_calls);
  * every distinct launch shape (kind, (N, K, h, L), table, pre_half) on
    random digits: raw digits identical to ladder_plain, the kernel's ms
    (CUDA events, median of R) and the plain version's, its bound
    (utils/profile.bound; 8 bytes per digit, inputs read once and outputs
    written once) and its share of it;
  * the sum over the recorded launches of count x ms: the ladder's device
    ms per product;
  * where the pointwise's Garner kernel took the post leg, that form at a
    full staged chunk of random inputs, checked and timed the same way;
  * the staged flagship's device ms for mul and sqr (CUDA events).
Prints one JSON object per size, then the card's nvidia-smi name and
power-limit line.  Needs a CUDA device; without one it raises."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import subprocess

import torch

from mpir_fft_tpu_torch import kernels
from mpir_fft_tpu_torch.models import huge
from mpir_fft_tpu_torch.models.mul import _pw_chunk_rows, _staged_flagship
from mpir_fft_tpu_torch.ops import fused, ntt, transforms
from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, digits_from_int
from mpir_fft_tpu_torch.ops.transforms import ifft_innermost_body, inner_group, inner_steps
from mpir_fft_tpu_torch.utils.params import cdiv, choose_params
from mpir_fft_tpu_torch.utils.profile import _events_ms, bound

SEED = 20261016

# bytes and int32 operations per output digit of the Garner post forms,
# before the ladder group's own stages: the dense tier reads three pairs of
# raw sums, the 4-step tier three residues, and each writes one digit
POST_COST = {"garner_carry_post": (28, 12), "garner_residues_post": (16, 20)}


@contextlib.contextmanager
def ladder_calls():
    """Record the ladder launches the transforms make inside the block:
    yields a dict (kind, shape, table?, pre_half) -> [count, steps, W, pe,
    pre_half] of the first such call."""
    seen: dict = {}
    real = transforms.fused_butterfly_ladder

    def recording(kind, xp, steps, W, pe=None, pre_half=None):
        key = (kind, tuple(xp.shape), pe is not None, pre_half is not None)
        if key in seen:
            seen[key][0] += 1
        else:
            seen[key] = [1, tuple(steps), W, None if pe is None else pe.clone(), pre_half]
        return real(kind, xp, steps, W, pe, pre_half)

    transforms.fused_butterfly_ladder = recording
    try:
        yield seen
    finally:
        transforms.fused_butterfly_ladder = real


def huge_passes(run, chunk_bytes: int | None = None):
    """(run(), passes): run() with every pass of models/huge.py recorded --
    the split stores, the column and row passes, the pointwise -- as
    (name, [the unpacked digits of each part, on the host]) in order; with
    chunk_bytes, CHUNK_BYTES and PW_CHUNK_BYTES set to it meanwhile (several
    chunks a pass at a small plan)."""
    seen: list = []
    names = ("_split_store", "_col_pass", "_row_pass", "_pointwise_rows")
    real = {n: getattr(huge, n) for n in names}
    chunks = huge.CHUNK_BYTES, huge.PW_CHUNK_BYTES

    def recording(name):
        def fn(*args, **kwargs):
            out = real[name](*args, **kwargs)
            for store in out if isinstance(out, tuple) else (out,):
                seen.append((name, [huge._unpack(u, m).cpu() for u, m in store.parts]))
            return out
        return fn

    try:
        for n in names:
            setattr(huge, n, recording(n))
        if chunk_bytes is not None:
            huge.CHUNK_BYTES = huge.PW_CHUNK_BYTES = chunk_bytes
        return run(), seen
    finally:
        for n in names:
            setattr(huge, n, real[n])
        huge.CHUNK_BYTES, huge.PW_CHUNK_BYTES = chunks


def _once_ms(fn):
    """(fn(), its device ms) for one run (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _record(rec: dict) -> dict:
    b, by = bound(rec["nbytes"], rec["ops"])
    return dict(rec, bound_ms=b, bound_by=by, share=b / rec["ms"])


def measure_launches(seen: dict, rand, reps: int) -> list[dict]:
    """Each distinct ladder launch of seen (ladder_calls) on digits from
    rand(shape, lo, hi) (canonical split digits for a pre_half group, else
    below 2^17 in size): its raw digits held against ladder_plain
    (AssertionError where they differ), then timed.  One dict per shape:
    name (ladder, ladder_pe or ladder_pre_half), kind, shape, launches, ms
    (median of reps after the checked run), plain_ms (one run), nbytes (the
    digits read and written once, the table read once), ops (one per digit
    and stage, two more for pre_half), bound_ms, bound_by and share."""
    out = []
    for (kind, shape, has_pe, has_pre), (count, steps, W, pe, pre) in seen.items():
        x = rand(shape, 0, 1 << 16) if has_pre else rand(shape, -(1 << 17), 1 << 17)
        name = "ladder_pre_half" if has_pre else "ladder_pe" if has_pe else "ladder"
        got = fused.fused_butterfly_ladder(kind, x, steps, W, pe, pre)
        want, pms = _once_ms(lambda: fused.ladder_plain(kind, x, steps, W, pe, pre))
        assert torch.equal(got, want), (name, kind, shape, "raw digits differ")
        del got, want
        ms = _events_ms(lambda: fused.fused_butterfly_ladder(kind, x, steps, W, pe, pre), reps)
        kg = shape[1].bit_length() - 1
        out.append(_record(dict(
            name=name, kind=kind, shape=list(shape), launches=count, ms=ms, plain_ms=pms,
            nbytes=8 * x.numel() + (0 if pe is None else 4 * pe.numel()),
            ops=(kg + (2 if has_pre else 0)) * x.numel())))
        del x
        torch.cuda.empty_cache()
    return out


def measure_post(name: str, fn, plain, parts, plan, reps: int) -> dict:
    """The Garner form fn (garner_carry or garner_residues, name its post
    form) with a staged chunk's post leg (plan's innermost inverse group)
    on the first _pw_chunk_rows(plan) rows of parts: its raw digits held
    against plain then ifft_innermost_body (AssertionError where they
    differ), then timed.  A dict of name, rows, M, K, steps, ms, plain_ms,
    nbytes, ops, bound_ms, bound_by and share."""
    M = plan.W // DIGIT_BITS
    h = plan.conv_len // 2
    kg = inner_group(h, M)
    K, steps = 1 << kg, inner_steps(plan.w, h, kg)
    chunk = [q[:_pw_chunk_rows(plan)] for q in parts]
    got = fn(*chunk, post=(K, steps))
    want, pms = _once_ms(lambda: ifft_innermost_body(plain(*chunk), steps, plan.W, K))
    assert got.dtype == want.dtype and torch.equal(got, want), (name, "raw digits differ")
    del got, want
    ms = _events_ms(lambda: fn(*chunk, post=(K, steps)), reps)
    rows = chunk[0].shape[0]
    per_byte, per_op = POST_COST[name]
    return _record(dict(name=name, rows=rows, M=M, K=K, steps=list(steps), ms=ms, plain_ms=pms,
                        nbytes=per_byte * rows * M, ops=(per_op + kg) * rows * M))


def _post_parts(plan, rand):
    """(name, fn, plain, parts): the Garner form that serves plan's ring and
    random inputs of one full staged chunk in its range."""
    M = plan.W // DIGIT_BITS
    rows = _pw_chunk_rows(plan)
    if M <= ntt.TIER1_MAX_M:
        lim = 2 * M * 128 * 128
        parts = [rand((rows, 2 * M), -lim, lim + 1) for _ in range(3)]
        return "garner_carry_post", ntt.garner_carry, ntt.garner_carry_plain, parts
    parts = [rand((rows, M), 0, p) for p in ntt.PRIMES_T2]
    return "garner_residues_post", ntt.garner_residues, ntt.garner_residues_plain, parts


def bench(bits: int, ntt0: bool, reps: int, dev) -> dict:
    env = os.environ.get("MPIR_FFT_NTT")
    if ntt0:
        os.environ["MPIR_FFT_NTT"] = "0"
    try:
        plan = choose_params(bits, bits, sqrt2=True)
        rnd = random.Random(SEED + bits)
        x, y = (rnd.getrandbits(bits) | (1 << (bits - 1)) for _ in range(2))
        dx, dy = (torch.from_numpy(digits_from_int(v, cdiv(bits, DIGIT_BITS))).to(dev)
                  for v in (x, y))
        run = _staged_flagship(plan)
        kernels.reset_launches()
        with ladder_calls() as seen:
            run(dx, dy)
        torch.cuda.synchronize()
        posted = kernels.LAUNCHES["garner_carry_post"] + kernels.LAUNCHES["garner_residues_post"]
        gen = torch.Generator(device=dev).manual_seed(SEED)

        def rand(shape, lo, hi):
            return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

        shapes = measure_launches(seen, rand, reps)
        post = None
        if posted:
            name, fn, plain, parts = _post_parts(plan, rand)
            post = measure_post(name, fn, plain, parts, plan, reps)
            del parts
        torch.cuda.empty_cache()
        mul_ms = _events_ms(lambda: run(dx, dy), reps)
        sqr_ms = _events_ms(lambda: run(dx), reps)
        L = plan.W // DIGIT_BITS
        return dict(bits=bits, ntt0=ntt0, plan=dict(depth=plan.depth, w=plan.w, L=L,
                                                     conv_len=plan.conv_len),
                    ladder_stages=fused.ladder_stages(L), ladder=shapes,
                    ladder_ms_per_mul=sum(r["launches"] * r["ms"] for r in shapes),
                    garner_post=post, staged_mul_ms=mul_ms, staged_sqr_ms=sqr_ms)
    finally:
        if env is None:
            os.environ.pop("MPIR_FFT_NTT", None)
        else:
            os.environ["MPIR_FFT_NTT"] = env


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int,
                    default=[100_000_000, 1_000_000_000, 2_000_000_000])
    ap.add_argument("--ntt0", nargs="*", type=int, default=[])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ladder_bench needs a CUDA device")
    dev = torch.device("cuda", 0)
    kernels.lib()
    for bits, ntt0 in [(b, False) for b in args.sizes] + [(b, True) for b in args.ntt0]:
        print(json.dumps(bench(bits, ntt0, args.reps, dev)), flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
