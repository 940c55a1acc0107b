"""The whole-row transform, the half-bit twiddle, the normmod rows, the
inverse sqrt2 top merge, the schoolbook and the exact carry at the shapes
the main path gives them, on the card: the per-shape measurement
chip_smoke.py also runs (measure_whole, measure_twiddle, measure_normmod,
measure_conv_base, measure_canon), and a tool beside utils/profile.py.

    python -m mpir_fft_tpu_torch.utils.transform_bench [--reps R] [--only K]

Whole-row transforms, (B, C, L, w) with B the rows of one launch:
  * (6528, 256, 48, 6) and (5376, 256, 64, 8): one pointwise chunk of the
    default plans at 1.08-1.3x10^9 and 1.4-1.6x10^9 bits (L 5120 / 6144
    rings, inner m 256);
  * (8192, 256, 32, 4) and (65536, 128, 72, 18): the inner transforms of the
    MPIR_FFT_NTT=0 plans at 10^8 and 10^9 bits;
  * wide rows (64-512 KB: one CTA of up to 227 KB or a cluster of 2, 4 or
    8): (2, 512, 80), (2, 1024, 64), (2, 1024, 128), (4, 1024, 96), the flat
    pair of mul at 1.5-3x10^5, 2x10^5, 5x10^5 and 7x10^5 bits; (256, 128,
    512), the 6.3x10^7 x 5x10^6 plan's MFA rows; (4, 128, 1024), a rank's
    rows of the sharded 10^8-bit product -- each also on the ladder route
    (raw digits identical, timed interleaved with the kernel: ab_ms) and its
    plain forward at every cluster size that holds it (R_ms);
each forward and inverse, plain (fused_transform) and weighted (the
negacyclic transforms of ops/negacyclic.py, the route mulmod_fft takes, so
that the script times any tree of the package alike: one launch where the
whole-row transform carries the weights, a twiddle_half launch beside a
transform launch where it does not).  Half-bit twiddles, (rows, L, h, e0,
step): the same chunks' weights at L 48 / 64 (rows B*256, step w), the
mulmod_int 2^29 ring's unweighting (32768, 4096, step -4), and the NTT=0
10^8 weights, an odd step at L 256 and an L % 4 != 0 row.

Normmod rows, (rows, L, d): normmod_div by 2^d (d 0: normmod) as the
recursive pointwise launches it -- the inner rings after the inverse
transform and the folded outer ring, per chunk of the default plans at
1.2x10^9 ((6528 x 256, 48), d 8; (6528, 5120)) and 1.5x10^9 ((5376 x 256,
64), d 8; (5376, 6144)), the 1.5x10^9 even-w norm tail (65536, 6144), and
the MPIR_FFT_NTT=0 plans' chunks at 10^8 ((8192 x 256, 32), (8192, 3072))
and 10^9 ((8192 x 128, 72), (8192, 4096)).  Long rows (rows, L, d, fill):
the mulmod_int rings' final normmod at N = 2^22, 2^24, 2^29 and 2^30
((1, 2^18), (1, 2^20), (1, 2^25), (1, 2^26); at 2^26 the random row by a
normmod_div shift 2W - 16, above 2^31), each "random" and "ripple" (all
0xFFFF, the top digit -1: every tile of the chained scan looks back, and
the carry out ripples through the whole row into the -1 form); timed
under the name "normmod (long)".

Inverse sqrt2 top merges, (C, L, w, lg_conv): the 1.2x10^9 plan's (65536,
5120), w 5, and the 10^9 plan's (131072, 2048), w 1, each with its norm
tail (canonical digits, held bit for bit); the 10^7 plan's (16384, 256)
with a tail (14) and without (0: redundant digits, held after normmod).
The forward top layer, (N, C, L, w): the 10^7 plan's stacked operands (2,
16384, 256), w 1 (held after normmod).

The schoolbook (mulmod_base_fused), (rows, L): the 1.2x10^9 default plan's
chunk of inner rings (6528 x 256, 48), and under MPIR_FFT_NTT=0 the inner
rings at 10^8 ((8192 x 256, 32)) and 10^9 ((8192 x 128, 72)) and the
outer rings of the 3,162,277 and 2x10^7-bit plans ((8192, 128), (16384,
512)).  Its output is held against conv_base_plain after normmod (raw
digits differ: the plain version carries chunk by chunk) and its digit
range recorded; its bound counts L^2 FMAs a row at the FP64 rate beside 12
bytes a digit; library_ms is a float64 grouped torch conv1d of the same
rows (the convolution without the recombination), a yardstick the port
never calls.

The exact carry (fused_canonicalize_plain), (rows, N, fill, offset): the
recursive pointwise's combines, one per chunk, at 1.2x10^9 ((6528, 5169),
the last chunk (256, 5169)) and 1.5x10^9 ((5376, 6209), last (1024,
6209)); the final product row of a mul at 2x10^7, 10^8, 10^9 and 1.2x10^9
bits ((1, 2500002), (1, 12500002), (1, 125000002), (1, 150000002)).  Each
"random" (digits in [0, 2^20); where rows > 1, row 0 a ripple from digit 0
that must stop at row 1) and "ripple" (every row all 0xFFFF but digit 0:
the carry runs the whole row, the look-back's worst case); two shapes
again one word off 16-byte alignment (offset 1: single-word runs).  Its
bound is 8 bytes a digit.

MFA column passes (fused_mfa_cols), (B, n1, n2, L, w, kind, trunc2,
trunc1): the 10^7 x 7x10^6-bit plan's four (128, 128, 256) launches (one
CTA a column); the 2x10^6-bit mfa driver's (64, 32, 512) columns, 64 KB
(one CTA each, 64 CTAs); the 6.3x10^7 x 5x10^6 plan's (256, 128, 512) columns (a
cluster of 2), full and truncated; the 3.7x10^7 x 3.3x10^7 mfa / mfa_trunc
plan's (128, 128, 1024), full and at trunc2 68 (4); the 7.4x10^7 x
6.6x10^7 plan's (256, 256, 1024) at trunc2 135 (8).  Each beside the
route a column pass takes without the kernel -- the truncate.py recursion
on the ladder with the cross table (mfa._run_cols' other branch) -- on the
same input: raw digits identical, both timed.

--only K runs one family: whole, twiddle, normmod, sqrt2, conv, canon or mfa.

For each: raw digits held against the plain version (AssertionError where
they differ), the kernel's device ms (CUDA events, median of R after a
warm-up; normmod also the kernels' own time from the profiler,
device_ms), the plain version's (one run), the bound (utils/profile.bound; 8
bytes per digit, inputs read once and outputs written once; one int32
operation per digit and stage, two more for the weights, four for a
twiddle) and the share of it.  Prints one JSON object per shape, then the
card's nvidia-smi name and power-limit line.  Needs a CUDA device."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from mpir_fft_tpu_torch import kernels
from mpir_fft_tpu_torch.ops import fused, mfa, negacyclic, transforms
from mpir_fft_tpu_torch.ops.truncate import truncated
from mpir_fft_tpu_torch.ops.pointwise import conv_base_plain, negacyclic_conv_chunks
from mpir_fft_tpu_torch.ops.pointwise_fused import mulmod_base_fused
from mpir_fft_tpu_torch.utils.profile import FP64_FMA_PER_S, INT32_OPS_PER_S, _events_ms, bound
from mpir_fft_tpu_torch.utils.tune import timed_ms

SEED = 20261016

WHOLE_SHAPES = ((6528, 256, 48, 6), (5376, 256, 64, 8), (8192, 256, 32, 4), (65536, 128, 72, 18),
                # wide rows (64-512 KB), root 2^(2W/C): the flat pair of mul at 1.5-3x10^5,
                # 2x10^5, 5x10^5 and 7x10^5 bits, the 6.3x10^7 x 5x10^6 plan's MFA rows, a
                # rank's rows of the sharded 10^8-bit product
                (2, 512, 80, 5), (2, 1024, 64, 2), (2, 1024, 128, 4), (4, 1024, 96, 3),
                (256, 128, 512, 128), (4, 128, 1024, 256))
NORMMOD_SHAPES = ((6528 * 256, 48, 8), (6528, 5120, 0), (5376 * 256, 64, 8), (5376, 6144, 0),
                  (65536, 6144, 16), (8192 * 256, 32, 8), (8192, 3072, 0),
                  (8192 * 128, 72, 7), (8192, 4096, 0))
NORMMOD_LONG_SHAPES = tuple((1, 1 << lg, 0, fill) for lg in (18, 20, 25)
                            for fill in ("random", "ripple")) + \
    ((1, 1 << 26, 16, "random"), (1, 1 << 26, 0, "ripple"))    # N = 2^30: 2W passes 2^31
SQRT2_INV_SHAPES = ((65536, 5120, 5, 16), (131072, 2048, 1, 17), (16384, 256, 1, 14),
                    (16384, 256, 1, 0))
SQRT2_FWD_SHAPES = ((2, 16384, 256, 1),)
CONV_SHAPES = ((6528 * 256, 48), (8192 * 256, 32), (8192 * 128, 72), (8192, 128), (16384, 512))
CANON_SHAPES = tuple((r, n, f, 0) for r, n in ((6528, 5169), (256, 5169), (5376, 6209),
                                               (1024, 6209), (1, 2500002), (1, 12500002),
                                               (1, 125000002), (1, 150000002))
                     for f in ("random", "ripple")) + ((6528, 5169, "random", 1),
                                                       (1, 12500002, "random", 1))
MFA_SHAPES = tuple((2 * 64, 64, 128, 256, 1, k, t, t < 128) for k, t in
                   (("fwd", 128), ("fwd", 11), ("inv", 128), ("inv", 11))) + \
    tuple((2 * 32, 32, 32, 512, 16, k, 32, False) for k in ("fwd", "inv")) + \
    tuple((2 * 128, 128, 128, 512, 1, k, t, t < 128) for k in ("fwd", "inv") for t in (128, 7)) + \
    tuple((128, 128, 128, 1024, 2, k, t, False) for k in ("fwd", "inv") for t in (128, 68)) + \
    tuple((2 * 128, 128, 256, 1024, 1, k, 135, False) for k in ("fwd", "inv"))
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


def _burst_ms(fn, reps: int, k: int = 10) -> float:
    """Device ms of one fn() from k back-to-back calls between two CUDA
    events (median of reps after a warm-up): the host's per-call work
    overlaps the kernels, as on the main path, where the host runs ahead."""
    fn()
    return _events_ms(lambda: [fn() for _ in range(k)], reps) / k


def _kernel_ms(fn, frag: str, n: int = 20) -> float:
    """Device ms per fn() call of the kernels whose names hold frag
    (torch.profiler over n calls after a warm-up): the card's own time,
    without the gaps a burst leaves where the host's work per call is the
    longer."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(ev.device_time_total for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA and frag in ev.key) / 1e3 / n


def _half_plain(x: torch.Tensor, e0: int, step: int, W: int) -> torch.Tensor:
    L, h = x.shape[-1], x.shape[-2]
    j = torch.arange(x.numel() // L, device=x.device) % h
    return fused.twiddle_half_rows_plain(
        x.reshape(-1, L), fused._affine_half_exps(j, e0, step, W), W).reshape(x.shape)


def _record(rec: dict, ops_per_s: float = INT32_OPS_PER_S) -> dict:
    b, by = bound(rec["nbytes"], rec["ops"], ops_per_s)
    return dict(rec, bound_ms=b, bound_by=by, share=b / rec["ms"])


def ab_ms(fa, fb, reps: int, warm: bool = True, device="cuda") -> tuple[float, float]:
    """Median device ms of fa() and fb(), interleaved a, b, b, a in each of
    reps rounds after one warm-up each (CUDA events; the host clock where
    device is the CPU; warm=False where the caller has just run both)."""
    dev = torch.device(device)
    if warm:
        fa()
        fb()
    ta, tb = [], []
    for _ in range(reps):
        for fn, acc in ((fa, ta), (fb, tb), (fb, tb), (fa, ta)):
            acc.append(timed_ms(fn, dev)[1])
    return statistics.median(ta), statistics.median(tb)


def measure_whole(B: int, C: int, L: int, w: int, rand, reps: int) -> list[dict]:
    """The four launches of one (B, C, L) shape at root 2^w: fwd and inv,
    plain and weighted (name transform_small / transform_small_half), each
    held against its plain version (raw digits), then timed.  A wide row
    (past 64 KB: a CTA of its own or a cluster, R CTAs a row) is also run on
    the ladder route (ops/transforms.py ladder_transform, the route such a
    row took before the whole-row transform held it), raw digits identical,
    the two timed
    interleaved (ms, ab_ms); its plain forward also at every cluster size
    that holds the row (R_ms, whole_cluster's pick among them)."""
    W = 16 * L
    D = C.bit_length() - 1
    x = rand((B, C, L), -(1 << 17), 1 << 17)
    wide = C * L * 4 > fused.WHOLE_BUF_BYTES

    def on_ladder(kind, **half):
        return transforms.ladder_transform(x, w, W, kind, **half)

    runs = (
        ("transform_small", "fwd", lambda: fused.fused_transform("fwd", x, w, W),
         lambda: fused.transform_plain("fwd", x, w, W), lambda: on_ladder("fwd")),
        ("transform_small", "inv", lambda: fused.fused_transform("inv", x, w, W),
         lambda: fused.transform_plain("inv", x, w, W), lambda: on_ladder("inv")),
        ("transform_small_half", "fwd", lambda: negacyclic.fft_negacyclic(x, w, W),
         lambda: fused.transform_plain("fwd", _half_plain(x, 0, w, W), w, W),
         lambda: on_ladder("fwd", pre_half=(0, w))),
        ("transform_small_half", "inv", lambda: negacyclic.ifft_negacyclic(x, w, W),
         lambda: _half_plain(fused.transform_plain("inv", x, w, W), 0, -w, W),
         lambda: on_ladder("inv", post_half=(0, -w))),
    )
    out = []
    for name, kind, fn, plain, ladder in runs:
        got = fn()
        want, pms = _once_ms(plain)
        assert torch.equal(got, want), (name, kind, (B, C, L), "raw digits differ")
        rec = dict(name=name, kind=kind, shape=[B, C, L], w=w)
        if wide:
            assert torch.equal(ladder(), want), (name, kind, (B, C, L), "ladder route differs")
            rec["R"] = fused.whole_cluster(B, C, L, fused._sm_count(x.device.index))
        del got, want
        torch.cuda.empty_cache()
        if wide:
            ms, rec["ab_ms"] = ab_ms(fn, ladder, reps)
        else:
            ms = _events_ms(fn, reps + 1)
        if wide and name == "transform_small" and kind == "fwd":
            rec["R_ms"] = {R: _events_ms(lambda: fused._launch_transform("fwd", x, w, W, None, R),
                                         reps + 1)
                           for R in fused.WHOLE_CLUSTERS
                           if fused.whole_smem_bytes(C, R, L) <= fused.WHOLE_CTA_SMEM}
        out.append(_record(dict(
            rec, ms=ms, plain_ms=pms, nbytes=8 * x.numel(),
            ops=(D + (2 if name.endswith("half") else 0)) * x.numel())))
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


def measure_normmod(rows: int, L: int, d: int, rand, reps: int, fill: str = "random") -> dict:
    """fused_normmod_div of (rows, L) digits by 2^d: "random", the ripple
    edge rows among them where rows > 2, or "ripple" (every row all 0xFFFF
    but its top digit, -1: the carry out -1 ripples through the whole row
    into the -1 form); held against normmod_rows_plain (raw digits), then
    timed in bursts (_burst_ms) and by the profiler (device_ms: the
    kernels' own time, _kernel_ms).  Named "normmod (long)" on the long
    route."""
    W = 16 * L
    s = (2 * W - d) % (2 * W)
    if fill == "ripple":
        x = torch.full((rows, L), 0xFFFF, dtype=torch.int32, device="cuda")
        x[:, L - 1] = -1
    else:
        x = rand((rows, L), -(1 << 18), 1 << 18)
        if rows > 2:
            x[0] = 0xFFFF
            x[1] = 0
            x[1, 0] = -1
            x[2] = 0
            x[2, L - 1] = 1 << 16
    got = fused.fused_normmod_div(x, s, W)
    want, pms = _once_ms(lambda: fused.normmod_rows_plain(x, s, W))
    assert torch.equal(got, want), ("normmod", (rows, L), d, fill, "digits differ")
    del got, want
    torch.cuda.empty_cache()
    ms = _burst_ms(lambda: fused.fused_normmod_div(x, s, W), reps)
    dms = _kernel_ms(lambda: fused.fused_normmod_div(x, s, W), "normmod_")
    name = "normmod (long)" if fused.normmod_route(L) == "long" else "normmod"
    return _record(dict(name=name, shape=[rows, L], d=d, fill=fill, ms=ms, device_ms=dms,
                        plain_ms=pms, nbytes=8 * x.numel(), ops=3 * x.numel()))


def _same_value(got: torch.Tensor, want: torch.Tensor, W: int) -> bool:
    """Equal digits after normmod, row by row (redundant outputs)."""
    L = got.shape[-1]
    return torch.equal(fused.normmod_rows_plain(got.reshape(-1, L), 0, W),
                       fused.normmod_rows_plain(want.reshape(-1, L), 0, W))


def measure_sqrt2_inv(C: int, L: int, w: int, nd: int, rand, reps: int) -> dict:
    """fused_sqrt2_top_inv of (C, L) digits at root w with norm_div nd (0:
    no norm tail): held against sqrt2_top_inv_plain (canonical digits bit
    for bit with the tail, equal after normmod without), then timed in
    bursts (_burst_ms)."""
    W = 16 * L
    x = rand((C, L), -(1 << 17), 1 << 17)
    got = fused.fused_sqrt2_top_inv(x, w, W, nd)
    want, pms = _once_ms(lambda: fused.sqrt2_top_inv_plain(x, w, W, nd))
    same = torch.equal(got, want) if nd else _same_value(got, want, W)
    assert same, ("sqrt2_top_inv", (C, L), nd, "digits differ")
    del got, want
    torch.cuda.empty_cache()
    ms = _burst_ms(lambda: fused.fused_sqrt2_top_inv(x, w, W, nd), reps)
    return _record(dict(name="sqrt2_top_inv", shape=[C, L], w=w, norm_div=nd, ms=ms,
                        plain_ms=pms, nbytes=8 * x.numel(), ops=9 * x.numel()))


def measure_sqrt2_fwd(N: int, C: int, L: int, w: int, rand, reps: int) -> dict:
    """fused_sqrt2_top_fwd of (N, C, L) digits at root w: held against
    sqrt2_top_fwd_plain (equal after normmod), then timed in bursts
    (_burst_ms)."""
    W = 16 * L
    x = rand((N, C, L), -(1 << 17), 1 << 17)
    got = fused.fused_sqrt2_top_fwd(x, w, W)
    want, pms = _once_ms(lambda: fused.sqrt2_top_fwd_plain(x, w, W))
    assert _same_value(got, want, W), ("sqrt2_top_fwd", (N, C, L), "values differ")
    del got, want
    torch.cuda.empty_cache()
    ms = _burst_ms(lambda: fused.fused_sqrt2_top_fwd(x, w, W), reps)
    return _record(dict(name="sqrt2_top_fwd", shape=[N, C, L], w=w, ms=ms, plain_ms=pms,
                        nbytes=8 * x.numel(), ops=6 * x.numel()))


def _conv1d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The negacyclic convolutions of the rows of a and b as one float64
    grouped conv1d (a row a group): [-b, b] correlated with a reversed."""
    x = torch.cat([-b, b], dim=-1).double()[None]
    y = torch.nn.functional.conv1d(x, a.double().flip(-1)[:, None], groups=a.shape[0])
    return y[0, :, 1:]


def measure_conv_base(rows: int, L: int, rand, reps: int) -> dict:
    """mulmod_base_fused on (rows, L) digits: held against conv_base_plain
    after normmod, its digit range recorded, then timed in bursts
    (_burst_ms); the float64 grouped conv1d of the same rows beside it as
    library_ms (checked on the first rows against the exact convolution)."""
    a = rand((rows, L), -(1 << 17), 1 << 17)
    b = rand((rows, L), -(1 << 17), 1 << 17)
    got = mulmod_base_fused(a, b)
    want, pms = _once_ms(lambda: conv_base_plain(a, b))
    W = 16 * L
    assert torch.equal(fused.normmod_rows_plain(got, 0, W), fused.normmod_rows_plain(want, 0, W)), \
        ("conv_base", (rows, L), "differs from the plain version after normmod")
    lo, hi = int(got.min()), int(got.max())
    del got, want
    torch.cuda.empty_cache()
    ms = _burst_ms(lambda: mulmod_base_fused(a, b), reps)
    k = min(rows, 64)
    exact = negacyclic_conv_chunks(a[:k].long(), b[:k].long())
    assert torch.equal(_conv1d(a[:k], b[:k]).long(), exact), ("conv1d", (rows, L))
    lib_ms = _burst_ms(lambda: _conv1d(a, b), 3, 1)
    torch.cuda.empty_cache()
    return _record(dict(name="conv_base", shape=[rows, L], ms=ms, plain_ms=pms, library_ms=lib_ms,
                        out_min=lo, out_max=hi, nbytes=12 * rows * L, ops=rows * L * L),
                   ops_per_s=FP64_FMA_PER_S)


def measure_canon(rows: int, N: int, fill: str, offset: int, rand, reps: int) -> dict:
    """fused_canonicalize_plain of (rows, N) digits (fill as above; offset:
    the input's words past a 16-byte boundary): held against
    canonicalize_plain_torch (digits equal), then timed in bursts
    (_burst_ms)."""
    buf = torch.empty(rows * N + offset, dtype=torch.int32, device="cuda")
    x = buf[offset:].view(rows, N)
    if fill == "random":
        x.copy_(rand((rows, N), 0, 1 << 20))
    ripple = x if fill == "ripple" else x[:1] if rows > 1 else x[:0]
    ripple.fill_(0xFFFF)
    ripple[:, 0] = 0x1FFFF
    x[:, -2:] = 0
    got = fused.fused_canonicalize_plain(x)
    want, pms = _once_ms(lambda: fused.canonicalize_plain_torch(x))
    assert torch.equal(got, want), ("canonicalize", (rows, N), fill, offset, "digits differ")
    del got, want
    torch.cuda.empty_cache()
    ms = _burst_ms(lambda: fused.fused_canonicalize_plain(x), reps)
    return _record(dict(name="canonicalize", shape=[rows, N], fill=fill, offset=offset, ms=ms,
                        plain_ms=pms, nbytes=8 * x.numel(), ops=3 * x.numel()))


def mfa_cols_ops(sched, B: int, L: int) -> int:
    """Digit operations of one column-kernel launch over B columns: each op
    of its schedule (ops/fused.py mfa_cols_schedule) times the rows it
    passes over -- a sub-transform of C rows log2(C) stages of C rows --
    one operation per digit and row pass, the convention of the ladder's
    rows."""
    rows = 0
    for op, lo, n, k, e1, e2, w, pe in sched:
        rows += {fused._OP_FFT: (n.bit_length() - 1) * n,
                 fused._OP_IFFT: (n.bit_length() - 1) * n,
                 fused._OP_TOP_FWD: n + k, fused._OP_FOLD: e1 - k, fused._OP_DOUBLE: n,
                 fused._OP_RESTORE: n, fused._OP_PE_DIV: n, fused._OP_TAIL0: 2 * (n - k),
                 fused._OP_TAIL1: 2 * (n - k), fused._OP_BFLY_INV: 2 * k, fused._OP_OUT1: k}[op]
    return rows * B * L


def ladder_route(kind: str, x: torch.Tensor, w: int, n1: int, trunc2: int,
                 one: bool) -> torch.Tensor:
    """The column pass of x (B, n2, L) without the column kernel: the
    truncate.py recursion on the ladder with the cross table, as
    mfa._run_cols runs the columns it does not fuse."""
    B, n2, L = x.shape
    W = 16 * L
    pe = mfa._cross_exps(n1, n2, w, W, x.device)
    return truncated(kind, one)(x.view(B // n1, n1, n2, L), w * n1, W, trunc2,
                                pe).reshape(B, n2, L)


def measure_mfa(B: int, n1: int, n2: int, L: int, w: int, kind: str, trunc2: int, one: bool,
                rand, reps: int) -> dict:
    """One column pass: the kernel against the ladder route on the same
    input, raw digits identical, each timed in bursts."""
    W = 16 * L
    x = rand((B, n2, L), -(1 << 17), 1 << 17)
    if kind == "fwd" and not one:
        x[:, trunc2:] = 0
    route = ladder_route(kind, x, w, n1, trunc2, one)
    got = fused.fused_mfa_cols(kind, x, w, W, n1, trunc2, one)
    torch.cuda.synchronize()
    assert torch.equal(got, route), ("mfa_cols", B, n2, L, kind, trunc2, one)
    del got, route
    ms = _burst_ms(lambda: fused.fused_mfa_cols(kind, x, w, W, n1, trunc2, one), reps)
    route_ms = _burst_ms(lambda: ladder_route(kind, x, w, n1, trunc2, one), reps, 3)
    rec = dict(name="mfa_cols", shape=[B, n2, L], n1=n1, w=w, kind=kind, trunc2=trunc2,
               trunc1=one, R=fused.mfa_col_cluster(n2, L), ms=ms,
               route_ms=route_ms, nbytes=8 * x.numel(),
               ops=mfa_cols_ops(fused.mfa_cols_schedule(kind, n2, w * n1, trunc2, one), B, L))
    b, by = bound(rec["nbytes"], rec["ops"])
    return dict(rec, bound_ms=b, bound_by=by, share=b / ms, speedup=route_ms / ms)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", choices=("whole", "twiddle", "normmod", "sqrt2", "conv", "canon",
                                       "mfa"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("transform_bench needs a CUDA device")
    dev = torch.device("cuda", 0)
    kernels.lib()
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    if args.only in (None, "whole"):
        for shape in WHOLE_SHAPES:
            for rec in measure_whole(*shape, rand, args.reps):
                print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
    if args.only in (None, "twiddle"):
        for shape in TWIDDLE_SHAPES:
            print(json.dumps(measure_twiddle(*shape, rand, args.reps)), flush=True)
            torch.cuda.empty_cache()
    if args.only in (None, "normmod"):
        for shape in NORMMOD_SHAPES:
            print(json.dumps(measure_normmod(*shape, rand, args.reps)), flush=True)
            torch.cuda.empty_cache()
        for rows, L, d, fill in NORMMOD_LONG_SHAPES:
            print(json.dumps(measure_normmod(rows, L, d, rand, args.reps, fill)), flush=True)
            torch.cuda.empty_cache()
    if args.only in (None, "sqrt2"):
        for shape in SQRT2_INV_SHAPES:
            print(json.dumps(measure_sqrt2_inv(*shape, rand, args.reps)), flush=True)
            torch.cuda.empty_cache()
        for shape in SQRT2_FWD_SHAPES:
            print(json.dumps(measure_sqrt2_fwd(*shape, rand, args.reps)), flush=True)
            torch.cuda.empty_cache()
    if args.only in (None, "conv"):
        for shape in CONV_SHAPES:
            print(json.dumps(measure_conv_base(*shape, rand, args.reps)), flush=True)
    if args.only in (None, "canon"):
        for shape in CANON_SHAPES:
            print(json.dumps(measure_canon(*shape, rand, args.reps)), flush=True)
            torch.cuda.empty_cache()
    if args.only in (None, "mfa"):
        for shape in MFA_SHAPES:
            print(json.dumps(measure_mfa(*shape, rand, args.reps)), flush=True)
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
