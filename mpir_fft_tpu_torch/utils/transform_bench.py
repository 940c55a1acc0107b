"""The whole-row transform and the half-bit twiddle at the shapes the main
path gives them, on the card: the per-shape measurement chip_smoke.py also
runs (measure_whole, measure_twiddle), and a tool beside utils/profile.py.

    python -m mpir_fft_tpu_torch.utils.transform_bench [--reps R]

Whole-row transforms, (B, C, L, w) with B the rows of one launch:
  * (6528, 256, 48, 6) and (5376, 256, 64, 8): one pointwise chunk of the
    default plans at 1.08-1.3x10^9 and 1.4-1.6x10^9 bits (L 5120 / 6144
    rings, inner m 256);
  * (8192, 256, 32, 4) and (65536, 128, 72, 18): the inner transforms of the
    MPIR_FFT_NTT=0 plans at 10^8 and 10^9 bits;
each forward and inverse, plain (fused_transform) and weighted (the
negacyclic transforms of ops/negacyclic.py, the route mulmod_fft takes, so
that the script times any tree of the package alike: one launch where the
whole-row transform carries the weights, a twiddle_half launch beside a
transform launch where it does not).  Half-bit twiddles, (rows, L, h, e0,
step): the same chunks' weights at L 48 / 64 (rows B*256, step w), the
mulmod_int 2^29 ring's unweighting (32768, 4096, step -4), and the NTT=0
10^8 weights, an odd step at L 256 and an L % 4 != 0 row.

For each: raw digits held against the plain version (AssertionError where
they differ), the kernel's device ms (CUDA events, median of R after a
warm-up), the plain version's (one run), the bound (utils/profile.bound; 8
bytes per digit, inputs read once and outputs written once; one int32
operation per digit and stage, two more for the weights, four for a
twiddle) and the share of it.  Prints one JSON object per shape, then the
card's nvidia-smi name and power-limit line.  Needs a CUDA device."""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from mpir_fft_tpu_torch import kernels
from mpir_fft_tpu_torch.ops import fused, negacyclic
from mpir_fft_tpu_torch.utils.profile import _events_ms, bound

SEED = 20261016

WHOLE_SHAPES = ((6528, 256, 48, 6), (5376, 256, 64, 8), (8192, 256, 32, 4), (65536, 128, 72, 18))
TWIDDLE_SHAPES = ((6528 * 256, 48, 256, 0, 6), (5376 * 256, 64, 256, 0, 8),
                  (32768, 4096, 32768, 0, -4), (8192 * 256, 32, 256, 0, 4),
                  (64 * 128, 256, 128, 3, 1), (64 * 64, 71, 64, 0, 5))


def _once_ms(fn):
    """(fn(), its device ms) for one run (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _half_plain(x: torch.Tensor, e0: int, step: int, W: int) -> torch.Tensor:
    L, h = x.shape[-1], x.shape[-2]
    j = torch.arange(x.numel() // L, device=x.device) % h
    return fused.twiddle_half_rows_plain(
        x.reshape(-1, L), fused._affine_half_exps(j, e0, step, W), W).reshape(x.shape)


def _record(rec: dict) -> dict:
    b, by = bound(rec["nbytes"], rec["ops"])
    return dict(rec, bound_ms=b, bound_by=by, share=b / rec["ms"])


def measure_whole(B: int, C: int, L: int, w: int, rand, reps: int) -> list[dict]:
    """The four launches of one (B, C, L) shape at root 2^w: fwd and inv,
    plain and weighted (name transform_small / transform_small_half), each
    held against its plain version (raw digits), then timed."""
    W = 16 * L
    D = C.bit_length() - 1
    x = rand((B, C, L), -(1 << 17), 1 << 17)
    runs = (
        ("transform_small", "fwd", lambda: fused.fused_transform("fwd", x, w, W),
         lambda: fused.transform_plain("fwd", x, w, W)),
        ("transform_small", "inv", lambda: fused.fused_transform("inv", x, w, W),
         lambda: fused.transform_plain("inv", x, w, W)),
        ("transform_small_half", "fwd", lambda: negacyclic.fft_negacyclic(x, w, W),
         lambda: fused.transform_plain("fwd", _half_plain(x, 0, w, W), w, W)),
        ("transform_small_half", "inv", lambda: negacyclic.ifft_negacyclic(x, w, W),
         lambda: _half_plain(fused.transform_plain("inv", x, w, W), 0, -w, W)),
    )
    out = []
    for name, kind, fn, plain in runs:
        got = fn()
        want, pms = _once_ms(plain)
        assert torch.equal(got, want), (name, kind, (B, C, L), "raw digits differ")
        del got, want
        torch.cuda.empty_cache()
        ms = _events_ms(fn, reps + 1)
        out.append(_record(dict(
            name=name, kind=kind, shape=[B, C, L], w=w, ms=ms, plain_ms=pms,
            nbytes=8 * x.numel(), ops=(D + (2 if name.endswith("half") else 0)) * x.numel())))
    return out


def measure_twiddle(rows: int, L: int, h: int, e0: int, step: int, rand, reps: int) -> dict:
    """fused_twiddle_half on (rows / h, h, L) digits: held against its plain
    version (raw digits), then timed."""
    W = 16 * L
    x = rand((rows // h, h, L), -(1 << 17), 1 << 17)
    got = fused.fused_twiddle_half(x, e0, step, W)
    want, pms = _once_ms(lambda: _half_plain(x, e0, step, W))
    assert torch.equal(got, want), ("twiddle_half", (rows, L), e0, step, "raw digits differ")
    del got, want
    torch.cuda.empty_cache()
    ms = _events_ms(lambda: fused.fused_twiddle_half(x, e0, step, W), reps + 1)
    return _record(dict(name="twiddle_half", shape=[rows, L], h=h, e0=e0, step=step, ms=ms,
                        plain_ms=pms, nbytes=8 * x.numel(), ops=4 * x.numel()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("transform_bench needs a CUDA device")
    dev = torch.device("cuda", 0)
    kernels.lib()
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    for shape in WHOLE_SHAPES:
        for rec in measure_whole(*shape, rand, args.reps):
            print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    for shape in TWIDDLE_SHAPES:
        print(json.dumps(measure_twiddle(*shape, rand, args.reps)), flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
