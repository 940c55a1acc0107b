#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mpir_fft_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit; fails without a CUDA device.
2. Builds the kernels from csrc/ (one nvcc per source, all at once, for
   sm_90a) and prints the build time and the compiler's resource lines.
3. Holds each of the twenty-eight kernels, and the NTT's int8 GEMM, against its
   plain torch version on the card at the shapes the main path gives it,
   and times both (CUDA events, warmed up, median):
     ladder, normmod, canonicalize -- the 2x10^7-bit plan (depth 12, w 2,
       L 512, conv 16384): every ladder group of the forward (operands
       stacked) and inverse transforms, normmod_div on (16384, 512),
       canonicalize on the 2.5 M-digit product (chained
       route), random and all one ripple, on the 4x10^9-bit product's
       5x10^8-digit combine (mul_huge's), and on the recursive pointwise's
       chunk combines (6528, 5169) and (5376, 6209) at 1.2 and 1.5x10^9
       bits (row route, a ripple row among them; utils/transform_bench
       measure_canon, ms beside bound and share);
     normmod at the recursive pointwise's shapes (utils/transform_bench
       measure_normmod, raw digits identical, ms beside bound and share):
       the inner rings' normmod_div (short rows) and the folded outer
       rings' normmod (block rows) of one chunk of the 1.2x10^9 and
       1.5x10^9-bit default plans, (6528 x 256, 48), (6528, 5120), (5376 x
       256, 64), (5376, 6144), the 1.5x10^9 norm tail (65536, 6144), and
       the MPIR_FFT_NTT=0 chunks at 10^8 and 10^9 bits;
     normmod (long) -- the mulmod_int rings' final normmod, one row of
       2^18, 2^20, 2^25 and 2^26 digits (N = 2^22, 2^24, 2^29, 2^30: the
       chained scan; at 2^26 a normmod_div shift above 2^31), random and
       all-0xFFFF ripple, raw digits identical, ms beside bound and share
       (measure_normmod), and the 2^18 row at three shifts;
     sqrt2_top_fwd -- the 10^7-bit plan (depth 12, w 1, L 256), stacked
       (2, 16384, 256); sqrt2_top_inv -- (16384, 256) with norm_div 14 and
       without a tail, and its launches in the 10^9-bit plan, (131072,
       2048), w 1, and the 1.2x10^9-bit plan, (65536, 5120), w 5, each with
       its norm tail (lg_conv 17 / 16) (utils/transform_bench
       measure_sqrt2_fwd / measure_sqrt2_inv, ms beside bound and share);
     mfa_cols -- the column pass of the 10^7 x 7x10^6-bit plan (depth 12,
       w 1, trunc_mfa 8896): the stacked halves' (2 x 64, 128, 256)
       columns (one CTA a column), forward full and fft_trunc1 at trunc2
       11, then the inverse full and ifft_trunc1 at 11 on those spectra;
       then one shape for each cluster size, n1 columns: (128, 128, 512)
       at trunc2 7, trunc1 (R 2; the 6.3x10^7 x 5x10^6 plan), (128, 128,
       1024) full (R 4; the mfa driver's 13 / 2 / 1024 plan), (128, 256,
       1024) at trunc2 135 (R 8; the 7.4x10^7 x 6.6x10^7 plan), forward
       then inverse, each beside the route its columns took before (the
       truncate.py recursion on the ladder) at the same shape; raw digits
       identical to the plain version (the truncate.py recursion; its
       sub-transforms would launch kernels on the card, so it runs on the
       host's CPU, and its time is a CPU time);
     ladder_pe -- the last group of the 10^9 x 10^8-bit plan's column
       transforms (L 2048, columns of 256: K 4, h 1, the stacked operands'
       512 columns) with the real cross-twiddle table, forward and inverse;
     ladder_pre_half -- the first group of the 10^9-bit plan's zero-top
       t-leg (1, 8, 8192, 2048), pre_half (0, w), raw digits identical; and
       the first group of each mulmod_int ring's inner forward transforms
       (2^22, 2^24, 2^29: the negacyclic weights), recorded from a mulmod;
     the ladder at the shapes that cost -- every distinct launch (kind,
       shape, option) of one staged product at 10^8, 10^9 and 2x10^9 bits
       and at the MPIR_FFT_NTT=0 10^8-bit plan (L 3072), recorded from the
       real run (utils/ladder_bench.ladder_calls) and measured by
       utils/ladder_bench.measure_launches: raw digits identical to
       ladder_plain, ms, bound and share per shape, and the ladder's ms per
       product (launches x ms);
     input_planes, mid_planes, garner_carry, int8_gemm -- the dense
       NTT-CRT pointwise of the 10^8-bit (32768 x 1024) and 10^9-bit
       (131072 x 2048) plans, each link fed the previous one's real output;
       garner_carry_post on each plan's first staged pointwise chunk (32768
       rows; the post leg K 16 / 8) against the plain Garner then
       ifft_innermost_body, raw digits identical, with its bound
       (utils/ladder_bench.measure_post);
     conv_base -- the 1.2x10^9-bit default plan's chunk of inner rings
       (6528 x 256, 48), and under MPIR_FFT_NTT=0 the inner rings of the
       10^8 and 10^9-bit plans (8192 x 256, 32), (8192 x 128, 72) and the
       pointwise of the 3,162,277-bit (8192, 128) and 2x10^7-bit (16384,
       512) plans: equal to conv_base_plain after normmod, digits inside
       (-2^6, 2^16 + 2^6), with a float64 grouped conv1d of the same rows
       as the library yardstick (utils/transform_bench.measure_conv_base);
     transform_small and transform_small_half (the weighted negacyclic
       transforms), forward and inverse, raw digits identical -- one
       pointwise chunk of the 1.2x10^9 and 1.5x10^9-bit default plans,
       (6528, 256, 48) w 6 and (5376, 256, 64) w 8, and (8192, 256, 32),
       (65536, 128, 72), the inner transforms at 10^8 and 10^9 bits under
       MPIR_FFT_NTT=0; and the wide rows (64-512 KB, one CTA or a cluster of
       R CTAs a row): the flat pair of mul at 3x10^5, 2x10^5, 5x10^5 and
       7x10^5 bits, (2, 512, 80), (2, 1024, 64), (2, 1024, 128), (4, 1024,
       96), the 6.3x10^7 x 5x10^6 plan's MFA rows (256, 128, 512) and a
       rank's sharded 10^8 rows (4, 128, 1024), each beside the ladder route
       those rows took before, interleaved on the same input (raw digits
       identical; ab_ms), the plain forward at every R that holds the row
       (utils/transform_bench.measure_whole);
     twiddle_half, raw digits identical -- those chunks' weights at L 48
       and 64, the mulmod_int 2^29 ring's unweighting (32768, 4096), the
       NTT=0 10^8 inner weights, an odd step at L 256, an L % 4 != 0 row
       (L 71) (utils/transform_bench.measure_twiddle);
     the 4-step tier's linked route (MPIR_FFT_NTT_FUSED=0:
       ntt4_input_planes, ntt4_fwd_twiddle, ntt4_pointwise,
       ntt4_inv_twiddle, ntt4_residues, garner_residues, and its GEMM) on
       the 2x10^9-bit plan's whole pointwise batch (131072, 4096), each link
       fed the previous one's real output, the plain versions compared
       slice by slice (four slices of 32768 rows: they do not fit beside
       the kernels' tensors whole), and garner_residues_post on its first
       staged chunk (16384 rows, K 4); ntt4_fused at the mulmod_int 2^29
       ring's batch (32768, 4096) and at (16384, 8192), product and square,
       its residues identical to the plain pipeline's and to the linked
       route's, timed beside its int8 and int32 bounds and the linked
       route (ntt4_input_planes, 18 GEMMs, the links), with ptxas's lines
       and cuobjdump's count of its tensor-core MMA instructions; the whole
       tier on B 1, 17 and 89 rows of M 4096 and 8192, its default (fused)
       route against the linked one, identical, timed in turns (medians of
       24 calls a side), product and square; fused
       (#9's counterpart: one whole block in one launch) forward and
       inverse at (64, 512), (256, 512) and (128, 1024), raw digits
       identical.  Then an A/B record on the same
       (131072, 4096) operands: mulmod_ntt's 4-step tier (fused) against the
       recursive mulmod_fft at mulmod_plan(65536), equal after normmod, both
       timed.
   Canonical outputs must be equal; the NTT links' outputs identical;
   other redundant outputs equal after normmod (they come out identical
   digit for digit) and inside their bounds.  Each kernel's bound_ms is the
   least time the card could take for the same work: the larger of its
   bytes (inputs read once, outputs written once) over 3.35 TB/s and its
   operations over the INT32 rate (the int8 tensor-core rate for the GEMM,
   the FP64 FMA rate for conv_base's L^2 FMAs a row; for ntt4_fused the
   larger of its int8 products at the tensor-core rate and the modular
   arithmetic it needs, with no load, store or address, at the INT32
   rate).  library_ms is one PyTorch call computing the same function, or
   null; ntt4_fused, which no one call computes, carries the linked route's
   time apart, as ab_ms.
4. Drives the main path, the launch counters reset before each size and
   read after it; every kernel the path should reach must have launched,
   and at the power-of-two plans conv_base must not have:
     mul/sqr at 3x10^5, 5x10^5 and 7x10^5 bits (full compare): the flat
       pair's batched transforms on the whole-row transform's wide rows
       (160-512 KB), no ladder launch at odd w (3x10^5, 7x10^5; the
       schoolbook pointwise), at even w (5x10^5) the lone 2-D inverse and
       sqr's forward on the ladder, as in the reference;
     mul/sqr at the default plans (dense NTT pointwise): 2x10^6 (full
       compare with Python's a*b), 10^7 (odd w), 2x10^7; from 10^8 up the
       staged route (flagship_is_staged: the zero-top forward launches
       ladder_pre_half and no sqrt2_top_fwd, each chunk's Garner takes the
       inverse leg, garner_*_post > 0 and no plain Garner): 10^8 and 10^9
       (odd w; residues mod 61-bit primes), 1.2x10^9 and 1.5x10^9 (depth 14,
       w 5 / 6, L 5120 / 6144: the pointwise recurses on inner m 256 rings,
       Lp 48 on the schoolbook / Lp 64 on the dense NTT, each weighted inner
       transform one transform_small_half launch: no twiddle_half, no plain
       transform_small, no NTT link at 1.2x10^9, no conv_base at 1.5x10^9),
       2x10^9 (depth 15, w 2, L 4096: the 4-step tier's fused route, no
       link and no GEMM; peak memory at most
       32 GiB), then an A/B record on its operands: models/huge.py mul_huge
       called directly on that plan (exactly 2^29 elements, so mul() stages
       it) against the staged route, digits identical, device ms
       interleaved and the peak of each;
     under MPIR_FFT_NTT=0, its A/B plans, with no NTT kernel launched:
       2x10^6 and 2x10^7 (even-w schoolbook; 2x10^6 full compare),
       3,162,277 (full compare) and 10^7 (odd-w schoolbook), 10^8 and 10^9
       (the recursive Fermat mulmod: inner Lp 32, and at 10^9 L 4096
       rings with inner Lp 72, the weights in transform_small_half and no
       twiddle_half; staged, the hook never consumed: no garner_*_post, the
       inverse leg on the ladder);
     mul at four unbalanced default plans that truncate the MFA
       (trunc_mfa < conv_len): 10^7 x 7x10^6 (full compare; the column
       kernel, the whole-row transform, the odd-w top layer), 6.3x10^7 x
       5x10^6 (odd w, L 512: its (128, 512) columns on the column kernel,
       clusters of 2, no ladder_pe; its (128, 512) rows on the whole-row
       transform: no ladder launch), 3.98x10^8 x
       1.99x10^8 (even w, L 2048) and 10^9 x 10^8 (odd w, L 2048; peak
       memory at most 24 GiB), residues; the two L 2048 ones staged (the
       row-IFFT leg per chunk, no Garner post leg); at each an A/B record
       against the full-length flat pair (the same plan with trunc_mfa =
       conv_len), the two interleaved in one run, products identical, and
       the truncated route's device kernels per call (torch.profiler); the
       balanced sizes above must launch neither mfa_cols nor ladder_pe;
     at every staged cell an A/B record (not a claim): the staged route
       against the unstaged mpn_mul_flagship / mpn_sqr_flagship on the same
       plan and operands, digits identical, device ms interleaved (ab_ms)
       and the peak memory of one call each;
     mul(a, b, driver=k) for the six other drivers at 2x10^6 x 1.4x10^6
       bits, full compare (mfa and mfa_trunc through the column kernel);
     mulmod_int at N = 2^22 and 2^24 (inner rings Lp 256 and 512, on the
       NTT) and 2^29 (inner m 32768, Lp 4096: the 4-step tier's fused
       route; one ring,
       so its transforms take the ladder: ladder_pre_half forward, a
       twiddle_half pass after the inverse; the final normmod on the long
       route at every N), against
       Python's product folded mod 2^N+1 (2^22) or the port's own mul,
       folded; 2^29 once more under MPIR_FFT_NTT_FUSED=0 (the linked
       route: ntt4_input_planes, the GEMMs, the links), both device times
       printed side by side;
       2^30 (inner m 65536, Lp 4096; the final normmod one row of 2^26
       digits);
     the pair tier (MPIR_FFT_NTT_PAIR=1, the reference's opt-in pointwise):
       pair_input_planes, mid_planes at its five primes and
       garner_pair_carry against their plain versions on each other's real
       output, raw outputs identical, at (3, 8), (3, 128) and the 10^8 /
       10^9 chunks (32768, 1024) / (32768, 2048) (those timed beside their
       bytes bound), garner_pair_carry also on all-0xFFFF and all-(-2^25)
       sums inside its digit bound; mul/sqr at 10^7, 10^8 and 10^9 bits and
       mulmod_int at 2^22 under the variable, exact (residues; folded), the
       pair links launched at all five primes (kernels.MID_PLANES_BY_PRIME),
       no dense Garner, the staged products' garner_post hook asked and never
       consumed; the same products with the variable unset launching exactly
       what the default runs above launched, the hook consumed; then the A/B
       (a record): utils/prof_pointwise's split of both tiers at the two
       chunks (GEMMs with their int8 ops/s, links beside their bytes bound,
       Garner) and the two whole pointwise products interleaved (P, D, D, P,
       20 calls each), and the staged 10^8 / 10^9 products under each tier
       (digits identical, device ms interleaved);
     fused -- no path of either package reaches the reference's fused(fn,
       x), so its counterpart is driven through its own entry point: the
       forward then the inverse of a (256, 512) block, equal to 256 times
       the block after normmod;
     the out-of-core engine (models/huge.py) with 64 KB chunks at two small
       plans (100,000 and 150,000 bits, depth 7: odd w with trunc_mfa > h,
       even w): every pass's packed output on the card identical to the
       same engine's on the host (the kernels' plain versions), products
       exact (full compare);
     mul/sqr at 4x10^9 bits (depth 16, w 1, L 4096, n1 256: past 2^29
       elements, out of core; odd w with trunc_mfa > h), residues mod 61-bit
       primes; the ladder launches recorded and each shape held against
       ladder_plain on the card and timed (measure_launches); host and
       device ms and the peak of each;
     mul at 4x10^9 x 4x10^8 bits (j1 > h: ten balanced pieces,
       _mul_piecewise, b shipped once), residues; the piece count, host ms
       and the pieces' device ms;
     mul_many at 16 pairs of 10^6 and 8 pairs of 10^7 bits (one batched
       driver call each), equal to a loop of mul, residues, and full
       compare of the 10^6 batch and one 10^7 pair; ms per product beside
       the loop (host clock) and beside single driver calls (device);
     the tools: each subcommand of mpir_fft_tpu_torch.cli in process,
       counted -- selftest at 2x10^5 bits (the seven drivers against GMP's
       mpn_mul, or Python's multiply where GMP is missing); mul through
       files at 10^7 and 10^8 bits (the product file equal to GMP's, else
       residues); mulmod at 2^22 (equal to Python's product folded); tune
       at 10^7 and 10^8 into a temporary cache (each candidate checked
       against the analytic product, its median and spread printed, and the
       kept plan); profile --stages at 10^8 and 10^9 (the composed stages'
       product equal to the route's, their times' sum within 0.8-1.5x of
       the route's device time in the same run); profile --transforms at
       depth 12, w 1; baseline at 10^7 (or the line that GMP is missing);
     the sharded path (parallel/, ops/mfa.py's sharded passes): four ranks
       spawned on cuda:0, joined by gloo (parallel/dryrun.run_ranks), each
       running utils/shard_bench.rank_phase on the same seeded operands --
       mul and sqr at 10^7 (unstaged: the column kernel on each rank's
       block, the whole-row transform on its rows, the top layer kernels),
       10^8 and 10^9 bits (the sharded staged flagship: full MFA columns on
       the ladder with their cross tables, the Garner hook declined at K =
       n1), mul at 6.3x10^7 x 5x10^6 (truncated, 7 kept rows padded to the
       ranks; twiddle_half rebuilds the inverse's tail), the 10^7 x 8 batch
       (two pairs a rank) and mul_huge at 10^9 bits, depth 16 (L 4096, the
       4-step tier), every store sharded -- each checked by residues on
       every rank, by GMP's product up to 10^8 bits where GMP is present,
       then timed: device ms, the exchanges' count, bytes and host ms, the
       peak memory, per rank; every kernel of SHARD_KERNELS launched on
       some rank, the whole-row transform on every rank's row pass at 10^8
       and 6.3x10^7 x 5x10^6; rank 0's ladder shapes held against ladder_plain and
       timed; the column kernel on a rank's block at its global columns;
       then the 10^9-bit product through NCCL at a world size of 1, equal to
       the gloo ranks'; and what NCCL answers two ranks on one card.
   For each: the plan, the launches, host-clock and CUDA-event times, and
   torch.cuda.max_memory_allocated().
5. Prints the kernel table as one JSON line, the card's line again, and the
   result line {"ok": true, "device": {...}} last.

Any failure raises and exits nonzero before the result line."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 20261016
PLAN_BITS = 20_000_000
SMALL_BITS = 2_000_000
WIDE_BITS = (300_000, 500_000, 700_000)
ODD_SMALL_BITS = 3_162_277
ODD_BITS = 10_000_000
REC_BITS = 100_000_000
HUGE_BITS = 1_000_000_000
T2_BITS = 2_000_000_000
REC5_BITS = 1_200_000_000     # the default plans whose pointwise recurses
REC6_BITS = 1_500_000_000
MULMOD_N = (1 << 22, 1 << 24, 1 << 29, 1 << 30)
# past 2^29 coefficient elements: the out-of-core flagship (odd w, t > h),
# balanced pieces, and the batches of mul_many (bits, pairs)
FOUR_BITS = 4_000_000_000
PIECES = (4_000_000_000, 400_000_000)
MANY = ((1_000_000, 16), (10_000_000, 8))
# unbalanced products whose default plans truncate the MFA (trunc_mfa <
# conv_len), and the drivers' size
UNB_SMALL = (10_000_000, 7_000_000)
UNB_MID = (63_095_734, 5_011_872)
UNB_EVEN = (398_107_170, 199_053_585)
UNB_HUGE = (1_000_000_000, 100_000_000)
DRIVER_BITS = (2_000_000, 1_400_000)
# the sharded phase (parallel/): ranks sharing cuda:0 over gloo, the specs
# of utils/shard_bench (label, route, bits_a, bits_b, depth, pairs), exact
# compare up to SHARD_FULL_BITS; NCCL at a world size of 1
SHARD_RANKS = 4
SHARD_SPECS = (("1e7", "mul", 10_000_000, 10_000_000, None, 0),
               ("1e8", "mul", 100_000_000, 100_000_000, None, 0),
               ("1e9", "mul", 1_000_000_000, 1_000_000_000, None, 0),
               ("6.3e7x5e6", "mul", 63_095_734, 5_011_872, None, 0),
               ("1e7x8", "many", 10_000_000, 10_000_000, None, 8),
               ("1e9 out of core d16", "huge", 1_000_000_000, 1_000_000_000, 16, 0))
SHARD_PLANS = {"1e7": (12, 1, 256, 16384, 16384, 64), "1e8": (13, 2, 1024, 32768, 32768, 128),
               "1e9": (15, 1, 2048, 131072, 131072, 256),
               "6.3e7x5e6": (13, 1, 512, 32768, 17280, 128),
               "1e7x8": (12, 1, 256, 16384, 16384, 64),
               "1e9 out of core d16": (16, 1, 4096, 262144, 61440, 256)}
SHARD_FULL_BITS = 100_000_000
# the kernels the sharded path must launch on some rank: every TPU kernel
# on the path but the ladder's pre_half (no zero-top when sharded), the
# Garner post leg (K = n1 rows fit the ladder only at small plans), the
# schoolbook, #9 and ntt4_fused
SHARD_KERNELS = ("ladder", "ladder_pe", "mfa_cols", "normmod", "canonicalize", "twiddle_half",
                 "sqrt2_top_fwd", "sqrt2_top_inv", "transform_small", "input_planes",
                 "mid_planes", "garner_carry", "ntt4_fused", "garner_residues", "int8_gemm")
MAX_PEAK_GIB_2E9 = 32.0
MAX_PEAK_GIB_UNB_HUGE = 24.0
SLICES = 4          # the plain 4-step links are held slice by slice

NTT_DIGIT_BOUND = (1 << 16) + (1 << 12)   # mulmod_ntt's redundant output bound
# the ladder's rows and the TPU kernel (option) each replaces
LADDER_REPLACES = {"ladder": "mpir_fft_tpu/ops/fused.py:250",
                   "ladder_pe": "mpir_fft_tpu/ops/fused.py:268",
                   "ladder_pre_half": "mpir_fft_tpu/ops/fused.py:275"}


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


def flat_plan(plan):
    """A copy of a truncating plan whose trunc_mfa is conv_len: the
    flagship then runs the full-length flat sqrt2 pair and the pointwise on
    every row, the path every plan took before the truncated MFA."""
    class Flat(type(plan)):
        trunc_mfa = property(lambda self: self.conv_len)
    return Flat(**dataclasses.asdict(plan))


def timed(fn):
    """(fn(), its device ms) for one run (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def wall_ms(fn, reps: int) -> float:
    """Median host-clock time of fn() (which ends in a host copy)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def ntt_off():
    """The reference's A/B setting MPIR_FFT_NTT=0: schoolbook and recursive
    pointwise, its A/B plans."""
    old = os.environ.get("MPIR_FFT_NTT")
    os.environ["MPIR_FFT_NTT"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["MPIR_FFT_NTT"]
        else:
            os.environ["MPIR_FFT_NTT"] = old


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


def mod_fermat(x: int, N: int) -> int:
    """x mod 2^N+1 for 0 <= x < 2^(2N+1) by one fold (2^N == -1): linear
    time, where Python's % by an N-bit modulus is quadratic."""
    p = (1 << N) + 1
    r = (x & ((1 << N) - 1)) - (x >> N)
    while r < 0:
        r += p
    return r


def kernel_name(sym: str) -> str:
    """name<integer template arguments> of a mangled kernel symbol (its
    length-prefixed identifier ending in _kernel), else the symbol."""
    for m in re.finditer(r"(?=(\d+))", sym):
        n, at = int(m.group(1)), m.start() + len(m.group(1))
        name = sym[at:at + n]
        if name.endswith("_kernel") and name.isidentifier():
            return f"{name}<{','.join(re.findall(r'L[ib](\d+)E', sym[at + n:]))}>"
    return sym


# #9's counterpart at blocks the column kernel holds in one CTA and in a
# cluster of 4: (C, L), W = 16 L, the full transform's root 2^(2W / C)
FUSED_BLOCKS = ((64, 512), (256, 512), (128, 1024))
# ntt4_fused's least int32 work: the modular arithmetic the function
# needs a value, with no load, store or address.  Each 32-bit add, shift,
# multiply or min is one operation; a 32 x 32 -> 64-bit multiply-add or a
# 64-bit add is two (its halves).  A fold of three plane sums (S0 + 256
# S1 + 65536 S2 and its Montgomery reduction) 8, a modular product 5, a
# plane split 4, a digit's balanced carry 4, the residue's range fix 2.
NTT4_NEED_OPS = {"fold": 8, "mul": 5, "split": 4, "carry": 4, "fix": 2}
# The same work as the kernel spends it, counted from csrc/ntt4_fused.cuh with its
# loads, stores and addresses (a diagnostic beside the bound, not the
# bound): a fold 9, a Montgomery product 5, a plane split with its three
# byte stores 8, an input digit's planes with its two loads 26, the
# residue's fix and store 4.
NTT4_IMPL_OPS = {"fold": 9, "mul": 5, "split": 8, "digit": 26, "fix": 4}


def pair_int32_ops(B: int, M: int) -> tuple[int, int]:
    """The least int32 operations of the pair tier's two links on B rows of
    M digits (as NTT4_NEED_OPS: the modular arithmetic the function needs,
    no load, store or address): pair_input_planes a digit's balanced carry
    4, a pair's residue at each prime (two reductions, a modular product,
    an add) 8 and its plane split 4; garner_pair_carry a pair's five folds
    5 each, the ten mixed-radix steps (a reduction and a modular product) 7
    each, the five digits' chunks 3 each, one multiply-add per nonzero byte
    of the place values and chunk, the five slot sums 2 each, two digit
    sums 3 each and two carries 4 each."""
    from mpir_fft_tpu_torch.ops.ntt import PRIMES_PAIR

    pairs = B * M // 2
    radix = [math.prod(PRIMES_PAIR[:j]) for j in range(len(PRIMES_PAIR))]
    mads = 3 * sum(1 for r in radix for k in range(8) if (r >> (8 * k)) & 0xFF)
    planes = B * M * 4 + pairs * len(PRIMES_PAIR) * (8 + 4)
    garner = pairs * (5 * 5 + 10 * 7 + 5 * 3 + mads + 5 * 2 + 2 * 3 + 2 * 4)
    return planes, garner


def ntt4_fused_int32_ops(B: int, M: int, impl: bool = False) -> int:
    """The int32 operations of ntt4_fused on B products of M digits: the
    least the function needs (impl: as the kernel spends them).  Per value
    of a row and prime: F1 (fold, times T, split) and F2's fold for each
    operand, the pointwise product and its split, G2 like F1, G1's fold and
    range fix.  A balanced digit's planes serve every prime, so the
    needed count takes each input digit's carry and split once, the
    kernel's once a prime."""
    o = NTT4_IMPL_OPS if impl else NTT4_NEED_OPS
    f1 = o["fold"] + o["mul"] + o["split"]
    per = 2 * (f1 + o["fold"]) + (o["mul"] + o["split"]) + f1 + (o["fold"] + o["fix"])
    if impl:
        return 3 * B * M * (per + 2 * o["digit"] + o["mul"])   # G1's constants: one more product
    return B * M * (3 * per + 2 * (o["carry"] + o["split"]))


def sass_dump(so: pathlib.Path):
    """cuobjdump's SASS of the library, started in a thread so that it runs
    beside the kernel phase (the interpreter joins the thread at exit):
    a future of its text, or None where the toolkit has no cuobjdump."""
    import concurrent.futures
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or (
        os.path.join(CUDA_HOME, "bin", "cuobjdump") if CUDA_HOME else None)
    if not tool or not os.path.exists(tool):
        return None
    pool = concurrent.futures.ThreadPoolExecutor(1)
    job = pool.submit(lambda: subprocess.run([tool, "-sass", str(so)], capture_output=True,
                                             text=True, timeout=300).stdout)
    pool.shutdown(wait=False)
    return job


def sass_mma_count(sass, name: str) -> str:
    """The tensor-core MMA instructions (wgmma: IGMMA / HGMMA; mma.sync:
    IMMA / HMMA) in the SASS (sass_dump's future) of each kernel whose
    symbol holds `name`."""
    if sass is None:
        return "cuobjdump not found"
    counts, fn = {}, None
    for line in sass.result().splitlines():
        if "Function :" in line:
            fn = kernel_name(line.split("Function :", 1)[1].strip())
            if name not in fn:
                fn = None
            else:
                counts.setdefault(fn, 0)
        elif fn and re.search(r"\b[IH]GMMA\b|\b[IH]MMA\b", line):
            counts[fn] += 1
    return json.dumps(counts) + " MMA instructions (IGMMA = wgmma.mma_async s8)"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device")
    t_start = time.perf_counter()
    card = gpu_line()
    print(f"gpu: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from mpir_fft_tpu_torch import kernels, mul_many, mulmod_int
    from mpir_fft_tpu_torch.models import mul as mm
    from mpir_fft_tpu_torch.models.huge import huge_serves, mul_huge, sqr_huge
    from mpir_fft_tpu_torch.models.mul import (
        DRIVERS, _piecewise_serves, _pw_chunk_rows, _staged_flagship, flagship_is_huge,
        flagship_is_staged, mpn_mul_flagship, mpn_sqr_flagship, mul, out_len_digits, sqr)
    from mpir_fft_tpu_torch.ops.fused import (
        CANON_ROW_MAX, CANON_TILE, fused, fused_butterfly_ladder, fused_mfa_cols,
        fused_normmod_div, fused_plain,
        ladder_groups, ladder_plain, ladder_stages, mfa_col_cluster, mfa_col_fits,
        mfa_cols_plain, mfa_cols_schedule, normmod_route, normmod_rows_plain, NORMMOD_ROW_MAX,
        NORMMOD_SHORT_MAX)
    from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, digits_from_int, int_from_digits, normmod
    from mpir_fft_tpu_torch.ops.mulmod import inner_plan, mulmod, mulmod_fft, mulmod_plan
    from mpir_fft_tpu_torch.ops.ntt import (
        PRIMES, PRIMES_PAIR, _blocks, _dot_raw, _ntt4_blocks, _ntt4_leg, _ntt4_shape,
        _pair_blocks, garner_carry, garner_carry_plain, garner_pair_carry,
        garner_pair_carry_plain, garner_residues, garner_residues_plain, input_planes,
        input_planes_plain, mid_planes, mid_planes_plain, mulmod_ntt, ntt4_fused,
        ntt4_fused_plain, ntt4_fwd_twiddle, ntt4_fwd_twiddle_plain, ntt4_input_planes,
        ntt4_input_planes_plain, ntt4_inv_twiddle, ntt4_inv_twiddle_plain, ntt4_pointwise,
        ntt4_pointwise_plain, ntt4_residues, ntt4_residues_plain, pair_input_planes,
        pair_input_planes_plain)
    from mpir_fft_tpu_torch.ops.mfa import _block_cross_exps
    from mpir_fft_tpu_torch.utils.ladder_bench import (huge_passes, ladder_calls,
                                                       measure_launches, measure_post)
    from mpir_fft_tpu_torch.utils.params import cdiv, choose_params, plan_for_depth
    from mpir_fft_tpu_torch.utils.prof_pointwise import env, pair_tier, profile_pointwise
    from mpir_fft_tpu_torch.utils.transform_bench import (
        CONV_SHAPES, NORMMOD_LONG_SHAPES, NORMMOD_SHAPES, TWIDDLE_SHAPES, WHOLE_SHAPES, ab_ms,
        ladder_route, measure_canon,
        measure_conv_base, measure_normmod, measure_sqrt2_fwd, measure_sqrt2_inv,
        measure_twiddle, measure_whole, mfa_cols_ops)
    # the card's peak rates (H100 SXM data sheet) and the bound they give
    from mpir_fft_tpu_torch.utils.profile import (FP64_FMA_PER_S, INT8_OPS_PER_S,
                                                  INT32_OPS_PER_S, bound,
                                                  device_kernels_per_call, random_operand)

    dev = torch.device("cuda", 0)

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.lib()
    sass = sass_dump(so)
    print(f"build: {time.perf_counter() - t0:.1f} s -> {so.name}")
    log = so.with_suffix(".log").read_text()
    print("  nvcc seconds a source: " + ", ".join(
        f"{m.group(1)} {m.group(2)}" for m in re.finditer(r"^nvcc (\S+): ([\d.]+) s$", log, re.M)))
    kernel, spill, ptxas_lines = "?", "", []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = kernel_name(line.split("'")[1])
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line:
            ptxas_lines.append(f"  ptxas: {kernel}: {line.split(':', 1)[1].strip()}; {spill}")
            print(ptxas_lines[-1])

    # -- 3. each kernel against its plain version at the main path's shapes ----
    plan = choose_params(PLAN_BITS, PLAN_BITS, sqrt2=True)
    C, W, L = plan.conv_len, plan.W, plan.W // DIGIT_BITS
    print(f"plan 2x10^7: {plan} L={L} conv={C}")
    assert (plan.depth, plan.w, L, C) == (12, 2, 512, 16384), plan
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    def canon(x):   # normmod through the plain version: independent of the kernels
        return normmod_rows_plain(x.reshape(-1, x.shape[-1]), 0, DIGIT_BITS * x.shape[-1])

    def compare(what, got, want, canonical=False, digit_bound=1 << 17):
        """max |canonical digit difference| of kernel vs plain (0 or raise);
        raw digits are compared first, and only unequal ones normalised."""
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        if canonical:
            assert same and is_canonical(got), what
            return 0, same
        err = 0 if same else int((canon(got) - canon(want)).abs().max())
        top = int(got.abs().max())
        assert err == 0, (what, err)
        assert top < digit_bound, (what, top)
        return err, same

    def identical(what, got, want):
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want), what

    rows = {}

    def add_row(name, source, replaces, err, ms, pms, nbytes, ops, library_ms=None,
                ops_per_s=INT32_OPS_PER_S, counter=None):
        """Add a timed shape to the kernel's row; counter: its LAUNCHES key
        (default: name)."""
        r = rows.setdefault(name, dict(name=name, counter=counter or name, route="cuda",
                                       source=source, replaces=replaces,
                                       max_abs_err=0, ms=0.0, plain_ms=0.0, nbytes=0.0, ops=0.0,
                                       library_ms=None, ops_per_s=ops_per_s))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += pms
        r["nbytes"] += nbytes
        r["ops"] += ops
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + library_ms

    # ladder: every group of the forward (stacked operands) and inverse transform
    w_half = plan.w // 2
    for kind, lead in (("fwd", 2), ("inv", 1)):
        for l, kg in ladder_groups(C, L, kind):
            K = 1 << kg
            shape = (lead << l, K, C >> (l + kg), L)
            steps = tuple(w_half << (l + j) for j in range(kg))
            x = rand(shape, -(1 << 17), 1 << 17)
            err, same = compare(("ladder", kind, shape), fused_butterfly_ladder(kind, x, steps, W),
                                ladder_plain(kind, x, steps, W))
            ms = time_ms(lambda: fused_butterfly_ladder(kind, x, steps, W), 10, 2)
            pms = time_ms(lambda: ladder_plain(kind, x, steps, W), 3)
            add_row("ladder", "mpir_fft_tpu_torch/csrc/ladder.cu",
                    LADDER_REPLACES["ladder"], err, ms, pms, 8 * x.numel(), kg * x.numel())
            print(f"ladder {kind} {shape}: equal after normmod, raw digits identical: {same}; "
                  f"{ms:.3f} ms (plain {pms:.3f} ms)")

    # normmod_div tail, with the ripple edge rows
    x = rand((C, L), -(1 << 18), 1 << 18)
    x[0] = 0xFFFF
    x[1] = 0
    x[2] = 0
    x[2, 0] = -1
    x[3] = 0
    x[3, L - 1] = 1 << 16       # carry out of the top: folds in as -1
    s = (2 * W - plan.lg_conv) % (2 * W)
    err, _ = compare("normmod", fused_normmod_div(x, s, W), normmod_rows_plain(x, s, W),
                     canonical=True)
    for s_edge in (0, 1, W - 1, W, W + 17, 2 * W - 1):
        assert torch.equal(fused_normmod_div(x[:64], s_edge, W),
                           normmod_rows_plain(x[:64], s_edge, W)), s_edge
    ms = time_ms(lambda: fused_normmod_div(x, s, W), 10, 2)
    pms = time_ms(lambda: normmod_rows_plain(x, s, W), 3)
    add_row("normmod", "mpir_fft_tpu_torch/csrc/normmod.cu", "mpir_fft_tpu/ops/fused.py:503",
            err, ms, pms, 8 * x.numel(), 3 * x.numel())
    print(f"normmod_div {tuple(x.shape)} d={plan.lg_conv}: exact; {ms:.3f} ms (plain {pms:.3f} ms)")
    # long rows (the mulmod_int rings' final normmod): the chained scan,
    # random and all-0xFFFF ripple rows, and the 2^18 row at three shifts
    for rows_l, Ll, d, fill in NORMMOD_LONG_SHAPES:
        rec = measure_normmod(rows_l, Ll, d, rand, 10, fill)
        add_row("normmod (long)", "mpir_fft_tpu_torch/csrc/normmod.cu",
                "mpir_fft_tpu/ops/fused.py:503", 0, rec["ms"], rec["plain_ms"], rec["nbytes"],
                rec["ops"], counter="normmod_long")
        print(f"normmod {tuple(rec['shape'])} {fill} (long row, chained scan): exact; "
              f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f}), bound "
              f"{rec['bound_ms']:.4f} ({rec['share']:.0%}; plain {rec['plain_ms']:.3f} ms)")
        torch.cuda.empty_cache()
    Ll = MULMOD_N[0] // DIGIT_BITS
    xl = rand((1, Ll), -(1 << 18), 1 << 18)
    xl[0, Ll - 1] = 1 << 20
    for sl in (3, 16 * Ll + 5, 2 * 16 * Ll - 12):
        compare(("normmod long", sl), fused_normmod_div(xl, sl, 16 * Ll),
                normmod_rows_plain(xl, sl, 16 * Ll), canonical=True)
    del xl
    # normmod at the recursive pointwise's shapes: short rows (the inner
    # rings) and block rows (the outer rings, the even-w norm tail), each
    # held against normmod_rows_plain and timed with its bound and share
    assert (kernels.lib().mf_normmod_short_max(), kernels.lib().mf_normmod_row_max()) == \
        (NORMMOD_SHORT_MAX, NORMMOD_ROW_MAX)
    for shape in NORMMOD_SHAPES:
        rec = measure_normmod(*shape, rand, 10)
        add_row("normmod", "mpir_fft_tpu_torch/csrc/normmod.cu", "mpir_fft_tpu/ops/fused.py:503",
                0, rec["ms"], rec["plain_ms"], rec["nbytes"], rec["ops"])
        print(f"normmod {tuple(rec['shape'])} d={rec['d']} ({normmod_route(shape[1])} rows): "
              f"exact; {rec['ms']:.3f} ms, bound {rec['bound_ms']:.3f} ({rec['share']:.0%}; "
              f"plain {rec['plain_ms']:.3f} ms)")
        torch.cuda.empty_cache()

    # exact carry: the recursive pointwise's chunk combines at 1.2 and
    # 1.5x10^9 bits (row route, a ripple row among them) and the product row
    # of this plan, random and all one ripple (chained route)
    assert (kernels.lib().mf_canonicalize_row_max(), kernels.lib().mf_canonicalize_tile()) == \
        (CANON_ROW_MAX, CANON_TILE)
    N = out_len_digits(plan)
    N4 = out_len_digits(choose_params(FOUR_BITS, FOUR_BITS, sqrt2=True))   # mul_huge's combine
    for shape in ((6528, 5169, "random", 0), (5376, 6209, "random", 0), (1, N, "random", 0),
                  (1, N, "ripple", 0), (1, N4, "random", 0)):
        rec = measure_canon(*shape, rand, 10)
        add_row("canonicalize", "mpir_fft_tpu_torch/csrc/canonicalize.cu",
                "mpir_fft_tpu/ops/fused.py:574", 0, rec["ms"], rec["plain_ms"], rec["nbytes"],
                rec["ops"])
        route = "row" if shape[1] <= CANON_ROW_MAX else "chained"
        print(f"canonicalize {tuple(rec['shape'])} {rec['fill']} ({route} route): exact; "
              f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ({rec['share']:.0%}; "
              f"plain {rec['plain_ms']:.3f} ms)")
        torch.cuda.empty_cache()
    del x

    # the sqrt2 top layer at the 10^7-bit plan (odd w), and the inverse's
    # launch in the 10^9 and 1.2x10^9-bit plans (w 1, L 2048; w 5, L 5120)
    # with the norm tail (utils/transform_bench measure_sqrt2_fwd /
    # measure_sqrt2_inv: canonical digits bit for bit with the tail, equal
    # after normmod without)
    oplan = choose_params(ODD_BITS, ODD_BITS, sqrt2=True)
    oW, oL, oC = oplan.W, oplan.W // DIGIT_BITS, oplan.conv_len
    print(f"plan 10^7: {oplan} L={oL} conv={oC}")
    assert (oplan.depth, oplan.w, oL, oC) == (12, 1, 256, 16384), oplan
    hplan = choose_params(HUGE_BITS, HUGE_BITS, sqrt2=True)
    rplan = choose_params(REC5_BITS, REC5_BITS, sqrt2=True)
    assert (hplan.w, hplan.W // DIGIT_BITS, hplan.conv_len) == (1, 2048, 131072), hplan
    assert (rplan.w, rplan.W // DIGIT_BITS, rplan.conv_len) == (5, 5120, 65536), rplan
    rec = measure_sqrt2_fwd(2, oC, oL, oplan.w, rand, 10)
    add_row("sqrt2_top_fwd", "mpir_fft_tpu_torch/csrc/sqrt2_top.cu",
            "mpir_fft_tpu/ops/fused.py:739", 0, rec["ms"], rec["plain_ms"], rec["nbytes"],
            rec["ops"])
    print(f"sqrt2_top_fwd {tuple(rec['shape'])} w={oplan.w}: equal after normmod; "
          f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ({rec['share']:.0%}; "
          f"plain {rec['plain_ms']:.3f} ms)")
    for p_, what in ((oplan, "10^7"), (oplan, "10^7, no tail"), (hplan, "10^9"),
                     (rplan, "1.2x10^9")):
        nd = 0 if what.endswith("no tail") else p_.lg_conv
        rec = measure_sqrt2_inv(p_.conv_len, p_.W // DIGIT_BITS, p_.w, nd, rand, 10)
        add_row("sqrt2_top_inv", "mpir_fft_tpu_torch/csrc/sqrt2_top.cu",
                "mpir_fft_tpu/ops/fused.py:783", 0, rec["ms"], rec["plain_ms"], rec["nbytes"],
                rec["ops"])
        print(f"sqrt2_top_inv {tuple(rec['shape'])} w={p_.w} norm_div={nd} (the {what} plan): "
              f"{'raw digits identical' if nd else 'equal after normmod'}; {rec['ms']:.4f} ms, "
              f"bound {rec['bound_ms']:.4f} ({rec['share']:.0%}; plain {rec['plain_ms']:.3f} ms)")
        torch.cuda.empty_cache()

    # the MFA column pass of the 10^7 x 7x10^6-bit plan: the stacked halves'
    # columns, forward full and fft_trunc1, then the inverse of each on its
    # spectra; the plain version on the host's CPU (see the docstring)
    uplan = choose_params(*UNB_SMALL, sqrt2=True)
    uW, uL, n1, n2 = uplan.W, uplan.W // DIGIT_BITS, uplan.n1, uplan.n2
    k2 = (uplan.trunc_mfa - uplan.conv_len // 2) // n1
    print(f"plan 10^7 x 7x10^6: {uplan} L={uL} n1={n1} n2={n2} trunc_mfa={uplan.trunc_mfa}")
    assert (uplan.depth, uplan.w, uL, uplan.trunc_mfa, n1, n2, k2) == \
        (12, 1, 256, 8896, 64, 128, 11), uplan
    assert mfa_col_fits(n2, uL, True) and mfa_col_cluster(n2, uL) == 1
    x = rand((2 * n1, n2, uL), -(1 << 17), 1 << 17)
    spectra = {}
    for kind, trunc2, src in (("fwd", n2, None), ("fwd", k2, None),
                              ("inv", n2, ("fwd", n2)), ("inv", k2, ("fwd", k2))):
        one = trunc2 < n2
        xin = x if src is None else spectra[src]
        got = fused_mfa_cols(kind, xin, uplan.w, uW, n1, trunc2, one)
        xh = xin.cpu()
        t0 = time.perf_counter()
        want = mfa_cols_plain(kind, xh, uplan.w, uW, n1, trunc2, one)
        pms = (time.perf_counter() - t0) * 1e3
        identical(("mfa_cols", kind, trunc2), got.cpu(), want)
        spectra[(kind, trunc2)] = got
        ms = time_ms(lambda: fused_mfa_cols(kind, xin, uplan.w, uW, n1, trunc2, one), 10, 2)
        ops = mfa_cols_ops(mfa_cols_schedule(kind, n2, uplan.w * n1, trunc2, one), 2 * n1, uL)
        add_row("mfa_cols", "mpir_fft_tpu_torch/csrc/mfa_cols.cu", "mpir_fft_tpu/ops/fused.py:200",
                0, ms, pms, 8 * xin.numel(), ops)
        print(f"mfa_cols {kind} {tuple(xin.shape)} trunc2={trunc2}{' (trunc1)' if one else ''}: "
              f"raw digits identical; {ms:.3f} ms (plain, on the host CPU, {pms:.1f} ms); "
              f"{ops / xin.numel():.1f} digit ops per digit")
    del x, spectra, xh, want
    # the columns the parent ran on the ladder, one shape for each cluster
    # size R, a batch of n1 columns (every j1 once): the 6.3x10^7 x 5x10^6
    # plan's (128, 512) at trunc2 7 (trunc1), the 3.7x10^7 x 3.3x10^7 mfa
    # driver's full (128, 1024), the 7.4x10^7 x 6.6x10^7 plan's (256, 1024)
    # at trunc2 135; forward, then the inverse on its spectra, each beside
    # that route (the truncate.py recursion on the ladder) at the same shape
    for cn1, cn2, cL, cw, ct2, cone, cR in ((128, 128, 512, 1, 7, True, 2),
                                            (128, 128, 1024, 2, 128, False, 4),
                                            (128, 256, 1024, 1, 135, False, 8)):
        assert mfa_col_fits(cn2, cL, ct2 == cn2) and mfa_col_cluster(cn2, cL) == cR
        cW = DIGIT_BITS * cL
        xin = rand((cn1, cn2, cL), -(1 << 17), 1 << 17)
        if not cone:
            xin[:, ct2:] = 0
        for kind in ("fwd", "inv"):
            got = fused_mfa_cols(kind, xin, cw, cW, cn1, ct2, cone)
            xh = xin.cpu()
            t0 = time.perf_counter()
            want = mfa_cols_plain(kind, xh, cw, cW, cn1, ct2, cone)
            pms = (time.perf_counter() - t0) * 1e3
            identical(("mfa_cols", kind, cn2, cL, ct2), got.cpu(), want)
            ms = time_ms(lambda: fused_mfa_cols(kind, xin, cw, cW, cn1, ct2, cone), 10, 2)
            route_ms = time_ms(lambda: ladder_route(kind, xin, cw, cn1, ct2, cone), 5, 1)
            ops = mfa_cols_ops(mfa_cols_schedule(kind, cn2, cw * cn1, ct2, cone), cn1, cL)
            add_row("mfa_cols", "mpir_fft_tpu_torch/csrc/mfa_cols.cu",
                    "mpir_fft_tpu/ops/fused.py:200", 0, ms, pms, 8 * xin.numel(), ops)
            bms, _ = bound(8 * xin.numel(), ops)
            print(f"mfa_cols {kind} {tuple(xin.shape)} trunc2={ct2}{' (trunc1)' if cone else ''}"
                  f", a cluster of {cR}: raw digits identical; {ms:.4f} ms, bound {bms:.4f} "
                  f"({bms / ms:.0%}); the ladder route {route_ms:.4f} ms ({route_ms / ms:.1f}x); "
                  f"plain, on the host CPU, {pms:.1f} ms")
            xin = got
        del xin, got, xh, want
    torch.cuda.empty_cache()

    # the ladder with its last-stage table: the group at the end (forward)
    # and start (inverse) of the 10^9 x 10^8-bit plan's column transforms --
    # columns of n2 at L 2048 exceed the column kernel and take the ladder --
    # over the stacked operands' 2 n1 columns, with their cross exponents
    hup = choose_params(*UNB_HUGE, sqrt2=True)
    hW, hL, hn1, hn2 = hup.W, hup.W // DIGIT_BITS, hup.n1, hup.n2
    print(f"plan 10^9 x 10^8: {hup} L={hL} n1={hn1} n2={hn2} trunc_mfa={hup.trunc_mfa}")
    assert (hup.depth, hup.w, hL, hup.trunc_mfa, hn1, hn2) == (15, 1, 2048, 67840, 256, 256), hup
    assert not mfa_col_fits(hn2, hL, False)
    D2 = hn2.bit_length() - 1
    cross = _block_cross_exps(2 * hn1, 0, hn1 - 1, hn2, hup.w, hW, dev)
    for kind, (l, kg) in (("fwd", ladder_groups(hn2, hL, "fwd")[-1]),
                          ("inv", ladder_groups(hn2, hL, "inv")[0])):
        assert l + kg == D2
        K = 1 << kg
        steps = tuple((hup.w * hn1) << (l + j) for j in range(kg))
        x = rand((2 * hn1 * (hn2 // K), K, 1, hL), -(1 << 17), 1 << 17)
        pe = cross.to(torch.int32).reshape(-1, K // 2, 2).contiguous()
        err, same = compare(("ladder_pe", kind), fused_butterfly_ladder(kind, x, steps, hW, pe),
                            ladder_plain(kind, x, steps, hW, pe))
        assert same, ("ladder_pe", kind, "raw digits differ")
        ms = time_ms(lambda: fused_butterfly_ladder(kind, x, steps, hW, pe), 10, 2)
        pms = time_ms(lambda: ladder_plain(kind, x, steps, hW, pe), 2)
        add_row("ladder_pe", "mpir_fft_tpu_torch/csrc/ladder.cu", LADDER_REPLACES["ladder_pe"],
                err, ms, pms, 8 * x.numel() + 4 * pe.numel(), kg * x.numel())
        print(f"ladder_pe {kind} {tuple(x.shape)} (group {l}+{kg} of {D2}): raw digits "
              f"identical; {ms:.3f} ms (plain {pms:.3f} ms)")
        del x, pe
    del cross
    torch.cuda.empty_cache()

    # the ladder with its pre_half twiddle: the first group of the 10^9-bit
    # plan's zero-top t-leg (fft_radix2 of the h split rows with pre_half =
    # (0, w)), on canonical split digits
    zplan = choose_params(HUGE_BITS, HUGE_BITS, sqrt2=True)
    zW, zL, zh = zplan.W, zplan.W // DIGIT_BITS, zplan.conv_len // 2
    l, kg = ladder_groups(zh, zL, "fwd")[0]
    K = 1 << kg
    steps = tuple(zplan.w << j for j in range(kg))
    x = rand((1, K, zh // K, zL), 0, 1 << 16)
    pre = (0, zplan.w)
    err, same = compare("ladder_pre_half", fused_butterfly_ladder("fwd", x, steps, zW, pre_half=pre),
                        ladder_plain("fwd", x, steps, zW, pre_half=pre))
    assert same, ("ladder_pre_half", "raw digits differ")
    ms = time_ms(lambda: fused_butterfly_ladder("fwd", x, steps, zW, pre_half=pre), 10, 2)
    pms = time_ms(lambda: ladder_plain("fwd", x, steps, zW, pre_half=pre), 2)
    add_row("ladder_pre_half", "mpir_fft_tpu_torch/csrc/ladder.cu",
            LADDER_REPLACES["ladder_pre_half"],
            err, ms, pms, 8 * x.numel(), (kg + 2) * x.numel())
    print(f"ladder_pre_half {tuple(x.shape)} (the 10^9 t-leg's first group, pre_half {pre}): raw "
          f"digits identical; {ms:.3f} ms (plain {pms:.3f} ms)")
    del x
    torch.cuda.empty_cache()

    # the ladder at every group shape of the staged flagships that cost:
    # 10^8, 10^9, 2x10^9 and the MPIR_FFT_NTT=0 10^8 plan (L 3072), each
    # shape recorded from one real product (ladder_calls), then held against
    # ladder_plain (raw digits identical) and timed alone, with its bytes
    # bound and share
    for bits, off in ((REC_BITS, False), (HUGE_BITS, False), (T2_BITS, False), (REC_BITS, True)):
        with ntt_off() if off else contextlib.nullcontext():
            mplan = choose_params(bits, bits, sqrt2=True)
            assert flagship_is_staged(mplan), mplan
            mL = mplan.W // DIGIT_BITS
            da = torch.from_numpy(digits_from_int(random.Random(bits).getrandbits(bits),
                                                  cdiv(bits, DIGIT_BITS))).to(dev)
            with ladder_calls() as seen:
                _staged_flagship(mplan)(da, da.flip(0))
            del da
            torch.cuda.empty_cache()
        tag = f"{bits:.0e}{' ntt0' if off else ''}"
        recs = measure_launches(seen, rand, 5)
        for r in recs:
            add_row(r["name"], "mpir_fft_tpu_torch/csrc/ladder.cu", LADDER_REPLACES[r["name"]],
                    0, r["ms"], r["plain_ms"], r["nbytes"], r["ops"])
            print(f"{r['name']} {tag} (plan {mplan.depth}/{mplan.w}/{mL}) {r['kind']} "
                  f"{tuple(r['shape'])}: x{r['launches']} per mul; raw digits identical; "
                  f"{r['ms']:.3f} ms, {r['bound_by']} bound {r['bound_ms']:.3f} ms "
                  f"({r['share']:.1%}); plain {r['plain_ms']:.3f} ms")
        print(f"ladder {tag}: {len(recs)} shapes, {sum(r['launches'] for r in recs)} launches "
              f"per mul, {sum(r['launches'] * r['ms'] for r in recs):.3f} ms per mul "
              f"(launches x ms)")

    # the ladder's pre_half at the mulmod_int rings, where the inner forward
    # transforms of one ring take the ladder and its first group carries the
    # negacyclic weights: each such launch recorded from one mulmod on random
    # residues, then measured as above
    for n_bits in MULMOD_N:
        mp = mulmod_plan(n_bits)
        dx, dy = (rand((n_bits // DIGIT_BITS,), 0, 1 << 16) for _ in range(2))
        with ladder_calls() as seen:
            mulmod(dx, dy, n_bits)
        del dx, dy
        torch.cuda.empty_cache()
        recs = measure_launches({k: v for k, v in seen.items() if k[3]}, rand, 5)
        assert recs, ("mulmod_int", n_bits, "no ladder_pre_half launch")
        for r in recs:
            add_row(r["name"], "mpir_fft_tpu_torch/csrc/ladder.cu", LADDER_REPLACES[r["name"]],
                    0, r["ms"], r["plain_ms"], r["nbytes"], r["ops"])
            print(f"{r['name']} mulmod_int 2^{n_bits.bit_length() - 1} (m {mp.m}, Lp {mp.Lp}) "
                  f"{r['kind']} {tuple(r['shape'])}: x{r['launches']} per product; raw digits "
                  f"identical; {r['ms']:.3f} ms, {r['bound_by']} bound {r['bound_ms']:.3f} ms "
                  f"({r['share']:.1%}); plain {r['plain_ms']:.3f} ms")

    def garner_post_row(name, fn, plain, parts, pplan):
        """Garner with the staged chunk's post leg (pplan's innermost
        inverse group) on the first chunk of parts, against the plain
        Garner then ifft_innermost_body: raw digits identical."""
        r = measure_post(name, fn, plain, parts, pplan, 10)
        add_row(name, "mpir_fft_tpu_torch/csrc/ntt_links.cu", "mpir_fft_tpu/ops/ntt.py:493",
                0, r["ms"], r["plain_ms"], r["nbytes"], r["ops"])
        print(f"{name} 3 x ({r['rows']}, {r['M']}) (a staged chunk, K {r['K']}, stages "
              f"{tuple(r['steps'])}): raw digits identical to Garner then ifft_innermost_body; "
              f"{r['ms']:.3f} ms, {r['bound_by']} bound {r['bound_ms']:.3f} ms "
              f"({r['share']:.1%}); plain {r['plain_ms']:.3f} ms")

    # the dense NTT-CRT pointwise of the 10^8 and 10^9 default plans: each
    # link on the previous one's real output, the GEMMs between them
    for bits, want_plan in ((REC_BITS, (13, 2, 1024, 32768)),
                            (HUGE_BITS, (15, 1, 2048, 131072))):
        nplan = choose_params(bits, bits, sqrt2=True)
        nB, nM = nplan.conv_len, nplan.W // DIGIT_BITS
        print(f"plan {bits:.0e}: {nplan} L={nM} conv={nB}")
        assert (nplan.depth, nplan.w, nM, nB) == want_plan, nplan
        blocks = _blocks(nM, dev)
        x = rand((nB, nM), -(1 << 17), 1 << 17)
        y = rand((nB, nM), -(1 << 17), 1 << 17)
        pa = input_planes(x)
        identical("input_planes", pa, input_planes_plain(x))
        ms = time_ms(lambda: input_planes(x), 10, 2)
        pms = time_ms(lambda: input_planes_plain(x), 3)
        add_row("input_planes", "mpir_fft_tpu_torch/csrc/ntt_links.cu",
                "mpir_fft_tpu/ops/ntt.py:698", 0, ms, pms, 10 * x.numel(), 3 * x.numel())
        print(f"input_planes {tuple(x.shape)}: planes identical; {ms:.3f} ms (plain {pms:.3f} ms)")
        pb = input_planes(y)
        del x, y
        parts = []
        for j, (p, F, G) in enumerate(blocks):
            sa = _dot_raw(pa[j], F)
            sb = _dot_raw(pb[j], F)
            if j == 0:
                # the GEMM against an exact float64 product (sums < 2^27)
                torch.cuda.synchronize()
                assert torch.equal(sa, (pa[j].double() @ F.double()).int()), "int8_gemm"
                ms = time_ms(lambda: _dot_raw(pa[j], F), 5, 1)
                pms = time_ms(lambda: (pa[j].double() @ F.double()).int(), 1, 0)
                Frow = F.contiguous()       # the same block row-major: another cuBLASLt path
                rms = time_ms(lambda: torch._int_mm(pa[j], Frow), 3, 1)
                del Frow
                K = 2 * nM
                gemm_bytes = nB * K + K * K + 4 * nB * K
                add_row("int8_gemm", "mpir_fft_tpu_torch/ops/ntt.py", "mpir_fft_tpu/ops/ntt.py:344",
                        0, ms, pms, gemm_bytes, 2 * nB * K * K, library_ms=ms,
                        ops_per_s=INT8_OPS_PER_S)
                print(f"int8_gemm ({nB}, {K}) @ ({K}, {K}): exact; {ms:.3f} ms with the "
                      f"column-major block (row-major block {rms:.3f} ms; float64 matmul "
                      f"{pms:.3f} ms)")
                if bits == HUGE_BITS:
                    # a record: the GEMM at the row counts of the staged L 2048
                    # pointwise chunks -- a full chunk, and the last, short
                    # chunk of each unbalanced plan
                    counts = [_pw_chunk_rows(nplan), 4096]
                    for ub in (UNB_EVEN, UNB_HUGE):
                        up = choose_params(*ub, sqrt2=True)
                        counts.append(up.trunc_mfa % _pw_chunk_rows(up))
                    gm = {r: time_ms(lambda: _dot_raw(pa[j][:r], F), 5, 1) for r in counts}
                    print("int8_gemm at staged chunk rows (record): " + ", ".join(
                        f"{r} rows {t:.3f} ms ({t / r * 1e3:.3f} us/row)" for r, t in gm.items()))
            pp = mid_planes(sa, sb, p)
            identical(("mid_planes", p), pp, mid_planes_plain(sa, sb, p))
            if j == 0:
                ms = time_ms(lambda: mid_planes(sa, sb, p), 10, 2)
                pms = time_ms(lambda: mid_planes_plain(sa, sb, p), 3)
                add_row("mid_planes", "mpir_fft_tpu_torch/csrc/ntt_links.cu",
                        "mpir_fft_tpu/ops/ntt.py:730", 0, ms, pms, 18 * nB * nM, 3 * nB * nM)
                print(f"mid_planes {tuple(sa.shape)} p={p}: planes identical (all primes); "
                      f"{ms:.3f} ms (plain {pms:.3f} ms)")
            del sa, sb
            parts.append(_dot_raw(pp, G))
            del pp
        del pa, pb
        d = garner_carry(*parts)
        err, same = compare("garner_carry", d, garner_carry_plain(*parts),
                            digit_bound=NTT_DIGIT_BOUND)
        assert same, "garner_carry: raw digits differ from the plain version"
        ms = time_ms(lambda: garner_carry(*parts), 10, 2)
        pms = time_ms(lambda: garner_carry_plain(*parts), 2)
        add_row("garner_carry", "mpir_fft_tpu_torch/csrc/ntt_links.cu",
                "mpir_fft_tpu/ops/ntt.py:465", err, ms, pms, 28 * nB * nM, 12 * nB * nM)
        print(f"garner_carry 3 x {tuple(parts[0].shape)}: digits identical, below 2^16 + 2^12; "
              f"{ms:.3f} ms (plain {pms:.3f} ms)")
        del d
        garner_post_row("garner_carry_post", garner_carry, garner_carry_plain, parts, nplan)
        del parts
        torch.cuda.empty_cache()

    # the schoolbook, half-bit twiddles and whole transforms at the shapes of
    # the MPIR_FFT_NTT=0 plans: 3,162,277 (odd w, L 128), 2x10^7 (even w,
    # L 512, the plan of the kernel phase above), 10^8 and 10^9 (the
    # recursive mulmod, inner rings Lp 32 and 72)
    with ntt_off():
        splan = choose_params(ODD_SMALL_BITS, ODD_SMALL_BITS, sqrt2=True)
        rplan = choose_params(REC_BITS, REC_BITS, sqrt2=True)
        mplan = mulmod_plan(rplan.W)
        hplan = choose_params(HUGE_BITS, HUGE_BITS, sqrt2=True)
        hmp = mulmod_plan(hplan.W)
        hchunk = _pw_chunk_rows(hplan)
        assert choose_params(PLAN_BITS, PLAN_BITS, sqrt2=True) == plan
    sL = splan.W // DIGIT_BITS
    print(f"MPIR_FFT_NTT=0 plans: 3,162,277 {splan} L={sL}; 10^8 {rplan} "
          f"L={rplan.W // DIGIT_BITS}; inner {mplan} m={mplan.m} Lp={mplan.Lp}; 10^9 {hplan} "
          f"L={hplan.W // DIGIT_BITS}; inner {hmp} m={hmp.m} Lp={hmp.Lp}")
    assert (splan.depth, splan.w, sL, splan.conv_len) == (11, 1, 128, 8192), splan
    assert (rplan.W // DIGIT_BITS, mplan.m, mplan.Lp, mplan.wp) == (3072, 256, 32, 4)
    assert (hplan.depth, hplan.w, hplan.W // DIGIT_BITS, hmp.m, hmp.Lp) == (14, 4, 4096, 128, 72)
    # the schoolbook at the 1.2x10^9 default plan's chunk of inner rings
    # (the main path) and at those MPIR_FFT_NTT=0 shapes (utils/transform_bench
    # measure_conv_base: equal after normmod, digits inside (-2^6, 2^16 +
    # 2^6), a float64 grouped conv1d beside it as the library yardstick)
    bplan = choose_params(REC5_BITS, REC5_BITS, sqrt2=True)
    bmp = inner_plan(bplan.W)
    assert CONV_SHAPES == ((_pw_chunk_rows(bplan) * bmp.m, bmp.Lp),
                           (rplan.conv_len * mplan.m, mplan.Lp), (hchunk * hmp.m, hmp.Lp),
                           (splan.conv_len, sL), (C, L)), CONV_SHAPES
    for shape in CONV_SHAPES:
        r = measure_conv_base(*shape, rand, 10)
        assert -(1 << 6) < r["out_min"] and r["out_max"] < (1 << 16) + (1 << 6), r
        add_row("conv_base", "mpir_fft_tpu_torch/csrc/conv_base.cu",
                "mpir_fft_tpu/ops/pointwise_fused.py:77", 0, r["ms"], r["plain_ms"], r["nbytes"],
                r["ops"], library_ms=r["library_ms"], ops_per_s=FP64_FMA_PER_S)
        print(f"conv_base {shape}: equal after normmod, digits in [{r['out_min']}, "
              f"{r['out_max']}]; {r['ms']:.3f} ms, {r['bound_by']} bound {r['bound_ms']:.3f} ms "
              f"({r['share']:.1%}); plain {r['plain_ms']:.3f} ms, float64 conv1d "
              f"{r['library_ms']:.3f} ms")
        torch.cuda.empty_cache()
    # the whole-row transform, plain and weighted, at one pointwise chunk of
    # the default plans at 1.2 and 1.5x10^9 bits and at the MPIR_FFT_NTT=0
    # inner batches of 10^8 and 10^9; the standalone twiddle at the same row
    # widths, the mulmod_int 2^29 unweighting and the odd / L % 4 != 0 rows
    # (utils/transform_bench: raw digits identical to the plain versions)
    assert ((rplan.conv_len, mplan.m, mplan.Lp, mplan.wp) in WHOLE_SHAPES
            and (hplan.conv_len, hmp.m, hmp.Lp, hmp.wp) in WHOLE_SHAPES)
    for bits, (B, m, Lp, wp) in zip((1_200_000_000, 1_500_000_000), WHOLE_SHAPES):
        bplan = choose_params(bits, bits, sqrt2=True)
        bmp = inner_plan(bplan.W)
        assert (_pw_chunk_rows(bplan), bmp.m, bmp.Lp, bmp.wp) == (B, m, Lp, wp), (bits, bmp)
    # the wide rows (64-512 KB, one CTA or a cluster of R a row) also beside
    # the ladder route they took before, interleaved on the same input (the
    # row's ab_ms: the ladder's ms summed over the wide shapes, wide_ms the
    # kernel's over the same shapes); their plain forward at each R (R_ms)
    for shape in WHOLE_SHAPES:
        for r in measure_whole(*shape, rand, 5):
            add_row(r["name"], "mpir_fft_tpu_torch/csrc/transform_small.cu",
                    "mpir_fft_tpu/ops/fused.py:171" if r["name"] == "transform_small"
                    else "mpir_fft_tpu/ops/fused.py:171 + :533", 0, r["ms"], r["plain_ms"],
                    r["nbytes"], r["ops"])
            wide = ""
            if "ab_ms" in r:
                row = rows[r["name"]]
                row["ab"] = "the ladder route on the wide rows (ops/transforms.py ladder_transform)"
                row["ab_ms"] = row.get("ab_ms", 0.0) + r["ab_ms"]
                row["wide_ms"] = row.get("wide_ms", 0.0) + r["ms"]
                wide = (f" R {r['R']}; the ladder route {r['ab_ms']:.4f} ms "
                        f"({r['ab_ms'] / r['ms']:.2f}x), interleaved"
                        + (f"; forward at R {json.dumps(r['R_ms'])}" if "R_ms" in r else "") + ";")
            print(f"{r['name']} {r['kind']} {tuple(r['shape'])} w={r['w']} (groups of "
                  f"{ladder_stages(r['shape'][2])}):{wide} raw digits identical; "
                  f"{r['ms']:.4f} ms, {r['bound_by']} bound {r['bound_ms']:.4f} ms "
                  f"({r['share']:.1%}); plain {r['plain_ms']:.3f} ms")
        torch.cuda.empty_cache()
    for shape in TWIDDLE_SHAPES:
        r = measure_twiddle(*shape, rand, 10)
        add_row("twiddle_half", "mpir_fft_tpu_torch/csrc/twiddle_half.cu",
                "mpir_fft_tpu/ops/fused.py:533", 0, r["ms"], r["plain_ms"], r["nbytes"], r["ops"])
        print(f"twiddle_half {tuple(r['shape'])} h={r['h']} e0={r['e0']} step={r['step']}: raw "
              f"digits identical; {r['ms']:.3f} ms, {r['bound_by']} bound {r['bound_ms']:.3f} ms "
              f"({r['share']:.1%}); plain {r['plain_ms']:.3f} ms")
        torch.cuda.empty_cache()

    # the 4-step tier at the 2x10^9-bit plan's pointwise batch: each link on
    # the previous one's real output (all three primes), the plain versions
    # held slice by slice, the kernels timed on the whole batch
    tplan = choose_params(T2_BITS, T2_BITS, sqrt2=True)
    tB, tM = tplan.conv_len, tplan.W // DIGIT_BITS
    m1, m2 = _ntt4_shape(tM)
    print(f"plan 2x10^9: {tplan} L={tM} conv={tB}")
    assert (tplan.depth, tplan.w, tM, tB) == (15, 2, 4096, 131072), tplan
    step = tB // SLICES
    BM = tB * tM

    def by_slices(what, got, plain, cut=lambda t, b0, b1: t[b0:b1]):
        """got (the kernel's output over tB b-rows) against plain(b0, b1) on
        SLICES row slices: identical; returns the plain ms summed."""
        total = 0.0
        for b0 in range(0, tB, step):
            want, ms = timed(lambda: plain(b0, b0 + step))
            identical((what, b0), cut(got, b0, b0 + step), want)
            total += ms
            del want
        return total

    src4 = "mpir_fft_tpu_torch/csrc/ntt4.cu"
    x = rand((tB, tM), -(1 << 17), 1 << 17)
    y = rand((tB, tM), -(1 << 17), 1 << 17)
    pa = ntt4_input_planes(x)
    pms = by_slices("ntt4_input_planes", pa, lambda b0, b1: ntt4_input_planes_plain(x[b0:b1]),
                    lambda t, b0, b1: t[:, b0 * m2:b1 * m2])
    ms = time_ms(lambda: ntt4_input_planes(x), 5, 1)
    add_row("ntt4_input_planes", src4, "mpir_fft_tpu/ops/ntt.py:821", 0, ms, pms, 13 * BM, 10 * BM)
    print(f"ntt4_input_planes {tuple(x.shape)} -> {tuple(pa.shape)}: planes identical "
          f"(plain in {SLICES} slices); {ms:.3f} ms (plain {pms:.3f} ms)")
    pb = ntt4_input_planes(y)
    res = []
    for j, blk in enumerate(_ntt4_blocks(tM, dev)):
        p = blk.p
        S1 = _dot_raw(pa[j], blk.F1)
        if j == 0:
            rows2, K = S1.shape
            sl = slice(0, step * m2)    # the GEMM against an exact float64 product (sums < 2^23)
            torch.cuda.synchronize()
            assert torch.equal(S1[sl], (pa[j][sl].double() @ blk.F1.double()).int()), "int8_gemm"
            ms = time_ms(lambda: _dot_raw(pa[j], blk.F1), 5, 1)
            pms = sum(timed(lambda: (pa[j][b0 * m2:(b0 + step) * m2].double()
                                     @ blk.F1.double()).int())[1] for b0 in range(0, tB, step))
            add_row("int8_gemm", "mpir_fft_tpu_torch/ops/ntt.py", "mpir_fft_tpu/ops/ntt.py:884",
                    0, ms, pms, rows2 * K + K * K + 4 * rows2 * K, 2 * rows2 * K * K,
                    library_ms=ms, ops_per_s=INT8_OPS_PER_S)
            print(f"int8_gemm 4-step ({rows2}, {K}) @ ({K}, {K}): exact; {ms:.3f} ms "
                  f"(float64 matmul {pms:.3f} ms, in {SLICES} slices)")
        pl2 = ntt4_fwd_twiddle(S1, p, tM)
        pms = by_slices("ntt4_fwd_twiddle", pl2,
                        lambda b0, b1: ntt4_fwd_twiddle_plain(S1[b0 * m2:b1 * m2], p, tM),
                        lambda t, b0, b1: t[b0 * m1:b1 * m1])
        if j == 0:
            ms = time_ms(lambda: ntt4_fwd_twiddle(S1, p, tM), 5, 1)
            add_row("ntt4_fwd_twiddle", src4, "mpir_fft_tpu/ops/ntt.py:783", 0, ms, pms,
                    15 * BM, 8 * BM)
            print(f"ntt4_fwd_twiddle {tuple(S1.shape)} -> {tuple(pl2.shape)} p={p}: planes "
                  f"identical (all primes); {ms:.3f} ms (plain {pms:.3f} ms)")
        del S1
        Sa = _dot_raw(pl2, blk.F2)
        del pl2
        Sb = _dot_raw(ntt4_fwd_twiddle(_dot_raw(pb[j], blk.F1), p, tM), blk.F2)
        pp = ntt4_pointwise(Sa, Sb, p, tM)
        pms = by_slices("ntt4_pointwise", pp,
                        lambda b0, b1: ntt4_pointwise_plain(Sa[b0 * m1:b1 * m1],
                                                            Sb[b0 * m1:b1 * m1], p, tM),
                        lambda t, b0, b1: t[b0 * m1:b1 * m1])
        if j == 0:
            ms = time_ms(lambda: ntt4_pointwise(Sa, Sb, p, tM), 5, 1)
            add_row("ntt4_pointwise", src4, "mpir_fft_tpu/ops/ntt.py:783", 0, ms, pms,
                    27 * BM, 10 * BM)
            print(f"ntt4_pointwise 2 x {tuple(Sa.shape)} p={p}: planes identical (all primes); "
                  f"{ms:.3f} ms (plain {pms:.3f} ms)")
        del Sa, Sb
        S3 = _dot_raw(pp, blk.G2)
        del pp
        pl4 = ntt4_inv_twiddle(S3, p, tM)
        pms = by_slices("ntt4_inv_twiddle", pl4,
                        lambda b0, b1: ntt4_inv_twiddle_plain(S3[b0 * m1:b1 * m1], p, tM),
                        lambda t, b0, b1: t[b0 * m2:b1 * m2])
        if j == 0:
            ms = time_ms(lambda: ntt4_inv_twiddle(S3, p, tM), 5, 1)
            add_row("ntt4_inv_twiddle", src4, "mpir_fft_tpu/ops/ntt.py:783", 0, ms, pms,
                    15 * BM, 8 * BM)
            print(f"ntt4_inv_twiddle {tuple(S3.shape)} -> {tuple(pl4.shape)} p={p}: planes "
                  f"identical (all primes); {ms:.3f} ms (plain {pms:.3f} ms)")
        del S3
        S4 = _dot_raw(pl4, blk.G1)
        del pl4
        r = ntt4_residues(S4, p, tM)
        pms = by_slices("ntt4_residues", r,
                        lambda b0, b1: ntt4_residues_plain(S4[b0 * m2:b1 * m2], p, tM))
        if j == 0:
            ms = time_ms(lambda: ntt4_residues(S4, p, tM), 5, 1)
            add_row("ntt4_residues", src4, "mpir_fft_tpu/ops/ntt.py:783", 0, ms, pms,
                    16 * BM, 4 * BM)
            print(f"ntt4_residues {tuple(S4.shape)} -> {tuple(r.shape)} p={p}: residues "
                  f"identical (all primes); {ms:.3f} ms (plain {pms:.3f} ms)")
        del S4
        res.append(r)
    del pa, pb, r
    d = garner_residues(*res)
    pms = by_slices("garner_residues", d,
                    lambda b0, b1: garner_residues_plain(*(r[b0:b1] for r in res)))
    top = int(d.abs().max())
    assert top < NTT_DIGIT_BOUND, ("garner_residues", top)
    ms = time_ms(lambda: garner_residues(*res), 5, 1)
    add_row("garner_residues", "mpir_fft_tpu_torch/csrc/ntt_links.cu",
            "mpir_fft_tpu/ops/ntt.py:465", 0, ms, pms, 16 * BM, 20 * BM)
    print(f"garner_residues 3 x {tuple(res[0].shape)}: digits identical, max |d| {top} < "
          f"2^16 + 2^12; {ms:.3f} ms (plain {pms:.3f} ms)")
    garner_post_row("garner_residues_post", garner_residues, garner_residues_plain, res, tplan)
    del res
    torch.cuda.empty_cache()

    # A/B record: the 4-step leaf against the recursive route on the same operands
    mp65 = mulmod_plan(DIGIT_BITS * tM)
    got4 = normmod(d)
    del d
    torch.cuda.empty_cache()
    rec = mulmod_fft(x, y, mp65)
    identical("4-step leaf vs recursive mulmod_fft", got4, rec)
    del got4, rec
    torch.cuda.empty_cache()
    ab4 = time_ms(lambda: mulmod_ntt(x, y), 3, 1)
    abr = time_ms(lambda: mulmod_fft(x, y, mp65), 2, 1)
    print(f"A/B (record, not a claim) on ({tB}, {tM}): mulmod_ntt 4-step (fused route) "
          f"{ab4:.3f} ms, "
          f"mulmod_fft at {mp65} (m {mp65.m}, Lp {mp65.Lp}) {abr:.3f} ms; equal after normmod")
    del x, y
    torch.cuda.empty_cache()

    # the fused kernel at its main-path batch (the mulmod_int 2^29 ring's)
    # and at an M 8192 batch: identical to the plain pipeline, product and
    # square; timed beside its two bounds (the int8 tensor cores' and the
    # int32 modular arithmetic it needs) and beside the linked route that
    # computes the same residues (ntt4_input_planes, 18 GEMMs, the links)
    t_phase = time.perf_counter()
    fplan = mulmod_plan(MULMOD_N[2])
    assert (fplan.m, fplan.Lp) == (32768, 4096), fplan
    for fB, fM in ((fplan.m, tM), (16384, 8192)):
        fm1, fm2 = _ntt4_shape(fM)
        x = rand((fB, fM), -(1 << 17), 1 << 17)
        y = rand((fB, fM), -(1 << 17), 1 << 17)
        fr = ntt4_fused(x, y)
        want, pms = timed(lambda: ntt4_fused_plain(x, y))
        identical(("ntt4_fused", fM), fr, want)
        identical(("ntt4_fused square", fM), ntt4_fused(x, x), ntt4_fused_plain(x, x))
        del want

        def linked():
            pa, pb = ntt4_input_planes(x), ntt4_input_planes(y)
            return torch.stack([_ntt4_leg(pa[i], pb[i], blk, fM)
                                for i, blk in enumerate(_ntt4_blocks(fM, dev))])

        identical(("linked route", fM), linked(), fr)
        del fr
        ms = time_ms(lambda: ntt4_fused(x, y), 3, 1)
        ms_sq = time_ms(lambda: ntt4_fused(x, x), 3, 1)
        lms = time_ms(linked, 3, 1)
        fmacs = 81 * fB * fM * (fm1 + fm2)   # 3 primes x 3 transforms x (9 M m1 + 9 M m2)
        eops = ntt4_fused_int32_ops(fB, fM)
        b8 = 2 * fmacs / INT8_OPS_PER_S * 1e3
        b32 = eops / INT32_OPS_PER_S * 1e3
        bimpl = ntt4_fused_int32_ops(fB, fM, impl=True) / INT32_OPS_PER_S * 1e3
        if fM == tM:
            # the bound is the larger of the two: both kinds of work must be done
            ops, rate = (eops, INT32_OPS_PER_S) if b32 >= b8 else (2 * fmacs, INT8_OPS_PER_S)
            add_row("ntt4_fused", "mpir_fft_tpu_torch/csrc/ntt4_fused.cu",
                    "mpir_fft_tpu/ops/ntt.py:1115", 0, ms, pms, 20 * fB * fM,
                    ops, ops_per_s=rate)
            # no one PyTorch call computes the residues: the A/B is the
            # linked route, kept apart from library_ms
            rows["ntt4_fused"].update(ab="linked route", ab_ms=lms)
        print(f"ntt4_fused ({fB}, {fM}) -> 3 x ({fB}, {fM}): residues identical to the plain "
              f"pipeline and to the linked route (product and square); {ms:.3f} ms (square "
              f"{ms_sq:.3f} ms); int8 bound {b8:.3f} ms ({b8 / ms:.1%}), int32 bound (the "
              f"modular arithmetic needed) {b32:.3f} ms ({b32 / ms:.1%}); the kernel's own "
              f"int32 count (with loads, stores, addresses; a diagnostic) {bimpl:.3f} ms "
              f"({bimpl / ms:.1%}); linked route {lms:.3f} ms; plain {pms:.3f} ms")
        del x, y
        torch.cuda.empty_cache()
    for line in ptxas_lines:
        if "ntt4_fused_kernel" in line:
            print(line)
    t_sass = time.perf_counter()
    print(f"ntt4_fused SASS: {sass_mma_count(sass, 'ntt4_fused_kernel')}")
    print(f"ntt4_fused phase: {time.perf_counter() - t_phase:.1f} s, of which waiting for "
          f"cuobjdump {time.perf_counter() - t_sass:.1f} s")

    # the 4-step tier at small batches (a mulmod_int ring, the flagship's L
    # 4096 / 8192 plans), whole: the default (fused) route against the
    # linked one (MPIR_FFT_NTT_FUSED=0), identical, timed in turns (ab_ms:
    # a, b, b, a) over 12 rounds, 24 calls a side, product and square
    def linked_tier(u, v):
        with env("MPIR_FFT_NTT_FUSED", "0"):
            return mulmod_ntt(u, v)

    small_ab = {}
    for sM in (4096, 8192):
        for sB in (1, 17, 89):
            x = rand((sB, sM), -(1 << 17), 1 << 17)
            y = rand((sB, sM), -(1 << 17), 1 << 17)
            identical(("4-step default vs linked", sB, sM), mulmod_ntt(x, y), linked_tier(x, y))
            identical(("4-step default vs linked, square", sB, sM), mulmod_ntt(x, x),
                      linked_tier(x, x))
            f_ms, l_ms = ab_ms(lambda: mulmod_ntt(x, y), lambda: linked_tier(x, y), 12)
            fs_ms, ls_ms = ab_ms(lambda: mulmod_ntt(x, x), lambda: linked_tier(x, x), 12)
            small_ab[f"{sB}x{sM}"] = {"fused": f_ms, "linked": l_ms, "fused_square": fs_ms,
                                      "linked_square": ls_ms}
            print(f"4-step tier ({sB}, {sM}), medians of 24 in turns (record, not a claim): "
                  f"product fused {f_ms:.4f} ms, linked {l_ms:.4f} ms ({l_ms / f_ms:.2f}x); "
                  f"square fused {fs_ms:.4f} ms, linked {ls_ms:.4f} ms ({ls_ms / fs_ms:.2f}x)")
    print("4-step tier small batches, ms: " + json.dumps(small_ab))
    del x, y

    # #9's counterpart: one whole block's transform in one launch (the
    # column kernel on one column), raw digits identical to its plain
    # version; blocks the column kernel holds in one CTA and in a cluster
    for kind in ("fwd", "inv"):
        for bC, bL in FUSED_BLOCKS:
            bW = DIGIT_BITS * bL
            bw = 2 * bW // bC
            xb = rand((bC, bL), -(1 << 17), 1 << 17)
            got = fused(kind, xb, bw, bW)
            want, pms = timed(lambda: fused_plain(kind, xb, bw, bW))
            identical(("fused", kind, bC, bL), got, want)
            ms = time_ms(lambda: fused(kind, xb, bw, bW), 10, 2)
            ops = mfa_cols_ops(mfa_cols_schedule(kind, bC, bw, bC, False), 1, bL)
            add_row("fused", "mpir_fft_tpu_torch/csrc/mfa_cols.cu", "mpir_fft_tpu/ops/fused.py:154",
                    0, ms, pms, 8 * bC * bL, ops)
            print(f"fused {kind} ({bC}, {bL}) (cluster of {mfa_col_cluster(bC, bL)}): raw digits "
                  f"identical to the plain version; {ms:.4f} ms (plain {pms:.3f} ms)")
    print(f"kernel phase done at {time.perf_counter() - t_start:.1f} s")

    # -- 4. the main path, counted per size --------------------------------------
    rnd = random.Random(SEED)
    primes = primes_61(4)
    launches_total = dict.fromkeys(kernels.LAUNCHES, 0)
    e2e = {}

    def operand(bits):
        return random_operand(rnd, bits)

    def on_card(v, bits):
        return torch.from_numpy(digits_from_int(v, cdiv(bits, DIGIT_BITS))).to(dev)

    peaks = {}
    ab_staged = {}
    launch_log = {}

    def peak_gib(fn) -> float:
        """Peak device memory of one fn() call, GiB (inputs on the card count)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 2**30

    def counted(label, expect, fn, forbid=()):
        """Run fn() with the counters reset; check every expected kernel
        launched and no forbidden one did, print the launches and the peak
        memory."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) * 1e3
        got = launch_log[label] = dict(kernels.LAUNCHES)
        for name, n in got.items():
            launches_total[name] += n
        peak = peaks[label] = torch.cuda.max_memory_allocated() / 2**30
        print(f"{label}: launches {json.dumps({k: n for k, n in got.items() if n})}; "
              f"host clock {dt:.1f} ms (incl. checks); peak memory {peak:.2f} GiB "
              f"(at {time.perf_counter() - t_start:.1f} s)")
        for name in expect:
            assert got[name] > 0, f"{label}: kernel {name} was not launched"
        for name in forbid:
            assert got[name] == 0, f"{label}: kernel {name} was launched"
        return out

    ntt = ("input_planes", "mid_planes", "garner_carry", "int8_gemm")
    even_ntt = ("ladder", "normmod", "canonicalize") + ntt
    odd_ntt = ("ladder", "sqrt2_top_fwd", "sqrt2_top_inv", "canonicalize") + ntt
    # staged zero-top plans: the t-leg's twiddle rides the ladder, no top
    # layer forward; every chunk's Garner takes the inverse leg
    posts = ("garner_carry_post", "garner_residues_post")
    ntt_post = ("input_planes", "mid_planes", "garner_carry_post", "int8_gemm")
    zerotop = ("ladder", "ladder_pre_half", "canonicalize")
    no_top = ("sqrt2_top_fwd", "conv_base", "garner_carry", "garner_residues")
    even = ("ladder", "conv_base", "normmod", "canonicalize")
    odd = ("ladder", "sqrt2_top_fwd", "sqrt2_top_inv", "conv_base", "canonicalize")
    # the recursive pointwise: batched inner rings take the whole-row
    # transform with the weights in it (no twiddle_half pass); a lone ring
    # (mulmod_int) the ladder, its forward weights in the first group and a
    # twiddle_half pass after the inverse
    rec = ("ladder", "transform_small_half", "conv_base", "normmod", "canonicalize")
    rec_flat_ntt = ("ladder", "ladder_pre_half", "twiddle_half", "normmod", "normmod_long",
                    "canonicalize") + ntt
    no_twiddle = ("twiddle_half", "transform_small")
    no_school = ("conv_base",)
    # the 4-step tier's default route (the fused kernel, then Garner), and
    # the links of its linked route (MPIR_FFT_NTT_FUSED=0, with the GEMMs)
    ntt4 = ("ntt4_fused", "garner_residues")
    ntt4_links = ("ntt4_input_planes", "ntt4_fwd_twiddle", "ntt4_pointwise", "ntt4_inv_twiddle",
                  "ntt4_residues")
    even_ntt4 = ("ladder", "ladder_pre_half", "normmod", "canonicalize", "garner_residues_post",
                 "ntt4_fused")
    # the 4-step leaf's default route, not the recursive route nor the
    # dense tier nor the linked route
    no_rec = ("conv_base", "transform_small", "transform_small_half", "twiddle_half",
              "input_planes", "mid_planes", "garner_carry", "int8_gemm") + ntt4_links

    def residues_agree(prod, x, y, ps):
        return all(prod % p == (x % p) * (y % p) % p for p in ps)

    def drive(bits, label, want_plan, expect, full, ps, reps, forbid=(), bits_b=None):
        """mul (and, balanced, sqr) at bits x bits_b (default: bits) through
        the flagship, counted and timed.  want_plan: (depth, w, L), or for
        an unbalanced size (depth, w, L, trunc_mfa) with trunc_mfa <
        conv_len: the truncated MFA."""
        bits_b = bits_b or bits
        tplan = choose_params(bits, bits_b, sqrt2=True)
        L = tplan.W // DIGIT_BITS
        inner = inner_plan(tplan.W)
        print(f"{label} plan: {tplan} L={L} conv={tplan.conv_len} trunc_mfa={tplan.trunc_mfa}"
              + (f"; inner {inner}" if inner else ""))
        got_plan = (tplan.depth, tplan.w, L, tplan.trunc_mfa)[:len(want_plan)]
        assert got_plan == want_plan, (label, tplan)
        unbalanced = bits_b != bits
        assert (tplan.trunc_mfa < tplan.conv_len) == unbalanced, (label, tplan)
        forbid = tuple(forbid) + ("normmod_long",)    # no plan's row is long
        if not unbalanced:
            forbid = forbid + ("mfa_cols", "ladder_pe")
        x, y = operand(bits), operand(bits_b)

        def run():
            pr = mul(x, y)
            assert (pr == x * y) if full else residues_agree(pr, x, y, ps), f"mul {label}"
            assert pr.bit_length() in (bits + bits_b - 1, bits + bits_b)
            if not unbalanced:
                sq = sqr(x)
                assert (sq == x * x) if full else residues_agree(sq, x, x, ps), f"sqr {label}"

        what = "mul" if unbalanced else "mul/sqr"
        counted(f"{what} {label}", expect, run, forbid)
        print(f"{what} {label}: exact "
              f"({'full compare' if full else f'residues mod {len(ps)} 61-bit primes'})")
        dx, dy = on_card(x, bits), on_card(y, bits_b)
        e2e[f"mul_{label}_ms"] = wall_ms(lambda: mul(x, y), reps)
        staged = flagship_is_staged(tplan)
        if unbalanced:
            # A/B record (not a claim): the truncated MFA against the flat pair
            fp = flat_plan(tplan)
            assert fp.trunc_mfa == fp.conv_len and fp.trunc == tplan.trunc
            assert torch.equal(mpn_mul_flagship(dx, dy, tplan), mpn_mul_flagship(dx, dy, fp)), label
            tr, fl = ab_ms(lambda: mpn_mul_flagship(dx, dy, tplan),
                           lambda: mpn_mul_flagship(dx, dy, fp), reps, warm=False)
            e2e[f"mul_{label}_truncated_device_ms"] = tr
            e2e[f"mul_{label}_flat_pair_device_ms"] = fl
            e2e[f"mul_{label}_truncated_kernels_per_call"] = device_kernels_per_call(
                lambda: mpn_mul_flagship(dx, dy, tplan))
        if staged:
            # A/B record (not a claim): the staged route mul() takes against
            # the unstaged flagship on the same plan and operands
            st = _staged_flagship(tplan)
            assert torch.equal(st(dx, dy), mpn_mul_flagship(dx, dy, tplan)), label
            ab = ab_staged[f"mul {label}"] = {}
            ab["staged_ms"], ab["unstaged_ms"] = ab_ms(
                lambda: st(dx, dy), lambda: mpn_mul_flagship(dx, dy, tplan), reps, warm=False)
            ab["staged_peak_gib"] = peak_gib(lambda: st(dx, dy))
            ab["unstaged_peak_gib"] = peak_gib(lambda: mpn_mul_flagship(dx, dy, tplan))
            e2e[f"mul_{label}_device_ms"] = ab["staged_ms"]
            if not unbalanced:
                assert torch.equal(st(dx), mpn_sqr_flagship(dx, tplan)), label
                ab = ab_staged[f"sqr {label}"] = {}
                ab["staged_ms"], ab["unstaged_ms"] = ab_ms(
                    lambda: st(dx), lambda: mpn_sqr_flagship(dx, tplan), reps, warm=False)
                ab["staged_peak_gib"] = peak_gib(lambda: st(dx))
                ab["unstaged_peak_gib"] = peak_gib(lambda: mpn_sqr_flagship(dx, tplan))
                e2e[f"sqr_{label}_device_ms"] = ab["staged_ms"]
        elif unbalanced:
            e2e[f"mul_{label}_device_ms"] = tr
        else:
            e2e[f"mul_{label}_device_ms"] = time_ms(lambda: mpn_mul_flagship(dx, dy, tplan), reps,
                                                    1 if reps > 1 else 0)
            e2e[f"sqr_{label}_device_ms"] = time_ms(lambda: mpn_sqr_flagship(dx, tplan), reps,
                                                    1 if reps > 1 else 0)
        if not unbalanced:
            e2e[f"sqr_{label}_ms"] = wall_ms(lambda: sqr(x), reps)
        print(f"{label} times: " + json.dumps({k: v for k, v in e2e.items() if label in k})
              + ("; staged A/B: " + json.dumps({k: v for k, v in ab_staged.items() if label in k})
                 if staged else ""))
        return dx, dy, tplan

    # the default plans: the dense NTT-CRT pointwise at every size
    drive(SMALL_BITS, "2e6", (9, 8, 256), even_ntt, True, primes, 5, no_school)
    drive(ODD_BITS, "1e7", (12, 1, 256), odd_ntt, False, primes, 3, no_school)
    drive(PLAN_BITS, "2e7", (12, 2, 512), even_ntt, False, primes, 3, no_school)
    # 3x10^5-7x10^5 bits: the flat pair's batched transforms are wide rows
    # (160-512 KB), one transform_small launch each; at odd w (3x10^5, 7x10^5;
    # the schoolbook pointwise at L 80 / 96) no ladder launch remains; at even
    # w (5x10^5) the inverse and sqr's forward are lone 2-D transforms, which
    # the ladder takes in both packages
    wide_odd = ("transform_small", "sqrt2_top_fwd", "sqrt2_top_inv", "conv_base", "canonicalize")
    drive(WIDE_BITS[0], "3e5", (8, 5, 80), wide_odd, True, primes, 3, ("ladder",) + ntt)
    drive(WIDE_BITS[1], "5e5", (8, 8, 128), ("transform_small",) + even_ntt, True, primes, 3,
          no_school)
    drive(WIDE_BITS[2], "7e5", (9, 3, 96), wide_odd, True, primes, 3, ("ladder",) + ntt)
    # staged from 10^8 up (flagship_is_staged): the zero-top forward
    drive(REC_BITS, "1e8", (13, 2, 1024), zerotop + ("normmod",) + ntt_post, False, primes, 3,
          no_top)
    drive(HUGE_BITS, "1e9", (15, 1, 2048), zerotop + ("sqrt2_top_inv",) + ntt_post, False,
          primes[:2], 1, no_top)
    e2e["peak_memory_1e9_gib"] = peaks["mul/sqr 1e9"]
    # the default plans that recurse (1.08-1.6x10^9 bits): L 5120 / 6144
    # rings, inner m 256 at Lp 48 (schoolbook) / Lp 64 (dense NTT), one
    # transform_small_half launch per weighted inner transform
    staged_rec = zerotop + ("transform_small_half", "normmod")
    no_post = ("ladder_pe", "mfa_cols", "sqrt2_top_fwd") + posts + no_twiddle
    no_ntt4 = ntt4_links + ntt4
    drive(REC5_BITS, "1.2e9", (14, 5, 5120), staged_rec + ("conv_base", "sqrt2_top_inv"), False,
          primes[:2], 1, no_post + ntt + no_ntt4)
    drive(REC6_BITS, "1.5e9", (14, 6, 6144), staged_rec + ntt, False, primes[:2], 1,
          no_post + ("conv_base", "sqrt2_top_inv") + no_ntt4)
    dx, dy, p2 = drive(T2_BITS, "2e9", (15, 2, 4096), even_ntt4, False, primes[:2], 1,
                       no_rec + no_top)
    e2e["peak_memory_2e9_gib"] = peaks["mul/sqr 2e9"]
    assert peaks["mul/sqr 2e9"] <= MAX_PEAK_GIB_2E9, peaks["mul/sqr 2e9"]
    # A/B record (not a claim): the out-of-core engine called directly on the
    # 2x10^9 plan (exactly 2^29 elements, so mul() stages it) against the
    # staged route, whose product drive() held by residues: digits identical
    assert huge_serves(p2) and not flagship_is_huge(p2)
    st2 = _staged_flagship(p2)
    assert torch.equal(mul_huge(dx, dy, p2), st2(dx, dy)), "mul_huge at 2e9"
    ab_huge = {}
    ab_huge["huge_ms"], ab_huge["staged_ms"] = ab_ms(lambda: mul_huge(dx, dy, p2),
                                                     lambda: st2(dx, dy), 1, warm=False)
    ab_huge["huge_peak_gib"] = peak_gib(lambda: mul_huge(dx, dy, p2))
    ab_huge["staged_peak_gib"] = peak_gib(lambda: st2(dx, dy))
    e2e["mul_2e9_huge_vs_staged"] = ab_huge
    print("mul 2e9 A/B (record, not a claim; device ms interleaved, peak GiB of one call): "
          f"out of core against staged, digits identical: {json.dumps(ab_huge)}")
    del dx, dy, st2
    torch.cuda.empty_cache()
    # unbalanced default plans: the truncated MFA (trunc_mfa < conv_len)
    drive(UNB_SMALL[0], "1e7x7e6", (12, 1, 256, 8896),
          ("mfa_cols", "transform_small", "sqrt2_top_fwd", "sqrt2_top_inv", "canonicalize") + ntt,
          True, primes, 3, no_school, bits_b=UNB_SMALL[1])
    drive(UNB_MID[0], "6.3e7x5e6", (13, 1, 512, 17280),
          ("mfa_cols", "transform_small", "sqrt2_top_fwd", "sqrt2_top_inv", "twiddle_half",
           "canonicalize") + ntt,
          False, primes, 3, no_school + ("ladder_pe", "ladder"), bits_b=UNB_MID[1])
    # staged and truncated: the row-IFFT leg per chunk, no Garner post leg
    drive(UNB_EVEN[0], "3.98e8x1.99e8", (14, 2, 2048, 36736),
          ("ladder_pe", "ladder", "normmod", "canonicalize") + ntt,
          False, primes[:2], 1, no_school + ("mfa_cols", "ladder_pre_half") + posts,
          bits_b=UNB_EVEN[1])
    drive(UNB_HUGE[0], "1e9x1e8", (15, 1, 2048, 67840),
          ("ladder_pe", "ladder", "sqrt2_top_fwd", "sqrt2_top_inv", "twiddle_half",
           "canonicalize") + ntt,
          False, primes[:2], 1, no_school + ("mfa_cols", "ladder_pre_half") + posts,
          bits_b=UNB_HUGE[1])
    e2e["peak_memory_1e9x1e8_gib"] = peaks["mul 1e9x1e8"]
    assert peaks["mul 1e9x1e8"] <= MAX_PEAK_GIB_UNB_HUGE, peaks["mul 1e9x1e8"]
    # the six other drivers, exact, at their own plans
    xa, xb = operand(DRIVER_BITS[0]), operand(DRIVER_BITS[1])
    for kind in sorted(DRIVERS):
        if kind == "flagship":
            continue
        got = counted(f"mul driver={kind} 2e6x1.4e6", ("canonicalize",),
                      lambda: mul(xa, xb, driver=kind))
        assert got == xa * xb, f"driver {kind}"
        if kind.startswith("mfa"):
            assert kernels.LAUNCHES["mfa_cols"] + kernels.LAUNCHES["ladder_pe"] > 0, kind
        e2e[f"mul_driver_{kind}_ms"] = wall_ms(lambda: mul(xa, xb, driver=kind), 3)
    print("drivers at 2e6x1.4e6: exact (full compare); times: "
          + json.dumps({k: v for k, v in e2e.items() if "driver" in k}))
    # MPIR_FFT_NTT=0: the A/B plans, the schoolbook (even and odd w) and the
    # recursive mulmod (inner Lp 32 at 10^8; at 10^9 L 4096 rings, which the
    # 4-step tier serves with the NTT on)
    with ntt_off():
        drive(SMALL_BITS, "2e6_ntt0", (10, 2, 128), even, True, primes, 5, ntt)
        drive(ODD_SMALL_BITS, "3162277_ntt0", (11, 1, 128), odd, True, primes, 5, ntt)
        drive(ODD_BITS, "1e7_ntt0", (12, 1, 256), odd, False, primes, 3, ntt)
        drive(PLAN_BITS, "2e7_ntt0", (12, 2, 512), even, False, primes, 3, ntt)
        # staged with the recursive pointwise: the hook is never consumed,
        # the inverse leg runs on the ladder
        drive(REC_BITS, "1e8_ntt0", (11, 24, 3072), rec + ("ladder_pre_half",), False, primes, 3,
              ntt + posts + no_twiddle)
        drive(HUGE_BITS, "1e9_ntt0", (14, 4, 4096), rec + ("ladder_pre_half",), False,
              primes[:2], 1, ntt + posts + no_twiddle)
    e2e["peak_memory_1e9_ntt0_gib"] = peaks["mul/sqr 1e9_ntt0"]

    def mulmod_case(n_bits, label, expect, forbid, xy=None, want=None):
        """mulmod_int at N = n_bits, counted; operands (x, y) drawn unless
        given; want: the value to hold it against (else the product,
        folded)."""
        lg = n_bits.bit_length() - 1
        mp = mulmod_plan(n_bits)
        print(f"mulmod_int N=2^{lg}{label}: {mp} m={mp.m} Lp={mp.Lp}")
        p_n = (1 << n_bits) + 1
        x, y = xy or (rnd.randrange(p_n), rnd.randrange(p_n))
        got = counted(f"mulmod_int 2^{lg}{label}", expect, lambda: mulmod_int(x, y, n_bits), forbid)
        if want is None:
            want = mod_fermat(x * y if n_bits == MULMOD_N[0] else mul(x, y), n_bits)
        assert got == want, f"mulmod_int at N = {n_bits}{label}"
        print(f"mulmod_int N=2^{lg}{label}: exact (against "
              f"{'Python' if n_bits == MULMOD_N[0] else 'the port'}'s product, folded"
              f"{'; the linked run' if xy else ''})")
        key = f"mulmod_2^{lg}{label.replace(' ', '_')}"
        dx = torch.from_numpy(digits_from_int(x, n_bits // DIGIT_BITS)).to(dev)
        dy = torch.from_numpy(digits_from_int(y, n_bits // DIGIT_BITS)).to(dev)
        reps = 1 if n_bits > MULMOD_N[1] else 3
        e2e[f"{key}_ms"] = wall_ms(lambda: mulmod_int(x, y, n_bits), reps)
        e2e[f"{key}_device_ms"] = time_ms(lambda: mulmod(dx, dy, n_bits, canonical=True), reps)
        print(f"{key} times: " + json.dumps({k: v for k, v in e2e.items() if key in k}))
        return mp, x, y, want

    no_mfa = ("mfa_cols", "ladder_pe")
    for n_bits in MULMOD_N[:2]:
        mulmod_case(n_bits, "", rec_flat_ntt, no_school + no_mfa + ("transform_small_half",))
    # 2^29: inner rings of Lp 4096 on the 4-step tier, fused (the default)
    # and linked
    ring_4step = ("ladder", "ladder_pre_half", "twiddle_half", "normmod", "normmod_long",
                  "canonicalize") + ntt4
    no_ring = tuple(k for k in no_rec if k != "twiddle_half") + no_mfa
    mp, x, y, want = mulmod_case(MULMOD_N[2], "", ring_4step, no_ring)
    assert (mp.m, mp.Lp) == (32768, 4096), mp
    with env("MPIR_FFT_NTT_FUSED", "0"):
        mulmod_case(MULMOD_N[2], " linked", ("ladder", "normmod", "normmod_long", "canonicalize",
                                             "garner_residues", "int8_gemm") + ntt4_links,
                    ("ntt4_fused", "conv_base", "transform_small", "input_planes") + no_mfa,
                    (x, y), want)
    print(f"mulmod_int 2^29 device ms (record, not a claim): fused (the default) "
          f"{e2e['mulmod_2^29_device_ms']:.3f}, MPIR_FFT_NTT_FUSED=0 (linked) "
          f"{e2e['mulmod_2^29_linked_device_ms']:.3f}")
    # 2^30: the final normmod is one row of 2^26 digits, where 2W = 2^31
    # passes a C int; inner rings of Lp 4096 on the 4-step tier, as at 2^29
    mp, *_ = mulmod_case(MULMOD_N[3], "", ring_4step, no_ring)
    assert (mp.m, mp.Lp) == (65536, 4096), mp
    e2e["peak_memory_mulmod_2^30_gib"] = peaks["mulmod_int 2^30"]

    # -- the pair tier (MPIR_FFT_NTT_PAIR=1, opt-in as in the reference) ------
    # 1. each link against its plain version on the previous link's real
    #    output, raw outputs identical: pair_input_planes, mid_planes at all
    #    five primes (18433 and 59393 among them), garner_pair_carry, at
    #    (3, 8), (3, 128) and the 10^8 / 10^9 pointwise chunks (32768, 1024)
    #    / (32768, 2048), those two timed beside their bytes bound;
    #    garner_pair_carry on all-0xFFFF and all-(-2^25) sums, inside its
    #    bound.  2. mul / sqr at 10^7, 10^8 and 10^9 bits (staged, 1 / 4
    #    chunks) and mulmod_int at 2^22 with the variable set, exact, counted:
    #    the pair links launch at all five primes, no dense Garner, the staged
    #    products' garner_post hook never consumed; then the same products
    #    unset launch exactly what the default drives above launched.  3. The
    #    A/B: the pointwise at the two chunks, pair against dense
    #    (utils/prof_pointwise: the split, each link beside its bytes bound,
    #    the GEMMs' int8 ops/s; the whole pointwise interleaved P, D, D, P,
    #    20 calls each), and the staged 10^8 / 10^9 products on the card.
    t_pair = time.perf_counter()
    src_pair = "mpir_fft_tpu_torch/csrc/ntt_pair.cu"
    pair_digits = (-(1 << 10), (1 << 16) + (1 << 10))     # garner_pair_carry's bound
    for pB, pM in ((3, 8), (3, 128), (32768, 1024), (32768, 2048)):
        x = rand((pB, pM), -(1 << 25), 1 << 25)
        y = rand((pB, pM), -(1 << 25), 1 << 25)
        pa = pair_input_planes(x)
        want, pms = timed(lambda: pair_input_planes_plain(x))
        identical(("pair_input_planes", pB, pM), pa, want)
        pb = pair_input_planes(y)
        identical(("pair_input_planes", pB, pM), pb, pair_input_planes_plain(y))
        del want
        parts, mid = [], []
        for j, (p, F, G) in enumerate(_pair_blocks(pM, dev)):
            sa, sb = _dot_raw(pa[j], F), _dot_raw(pb[j], F)
            pp = mid_planes(sa, sb, p)
            identical(("mid_planes", p, pB, pM), pp, mid_planes_plain(sa, sb, p))
            if pB > 3:
                mid.append(time_ms(lambda: mid_planes(sa, sb, p), 10, 2))
            del sa, sb
            parts.append(_dot_raw(pp, G))
            del pp
        d = garner_pair_carry(*parts)
        want, gpms = timed(lambda: garner_pair_carry_plain(*parts))
        identical(("garner_pair_carry", pB, pM), d, want)
        assert pair_digits[0] < int(d.min()) and int(d.max()) < pair_digits[1], (pB, pM)
        del want, d
        if pB > 3:
            ims = time_ms(lambda: pair_input_planes(x), 10, 2)
            gms = time_ms(lambda: garner_pair_carry(*parts), 10, 2)
            iops, gops = pair_int32_ops(pB, pM)
            add_row("pair_input_planes", src_pair, "mpir_fft_tpu/ops/ntt.py:640", 0, ims, pms,
                    9 * pB * pM, iops)
            add_row("garner_pair_carry", src_pair, "mpir_fft_tpu/ops/ntt.py:558", 0, gms, gpms,
                    24 * pB * pM, gops)
            rec = e2e[f"pair_links_{pB}x{pM}"] = {}
            for name, ms, pl, nbytes, ops in (
                    ("pair_input_planes", ims, pms, 9 * pB * pM, iops),
                    ("mid_planes (5 primes)", sum(mid), None, 5 * 9 * pB * pM, 0),
                    ("garner_pair_carry", gms, gpms, 24 * pB * pM, gops)):
                bms, by = bound(nbytes, ops)
                rec[name] = {"ms": ms, "plain_ms": pl, "bound_ms": bms, "bound_by": by,
                             "share": bms / ms}
                print(f"{name} ({pB}, {pM}): identical to its plain version; {ms:.4f} ms, "
                      f"{by} bound {bms:.4f} ms ({bms / ms:.1%})"
                      + (f"; plain {pl:.3f} ms" if pl is not None else
                         f"; per prime {json.dumps([round(t, 4) for t in mid])}"))
        del x, y, pa, pb, parts
        torch.cuda.empty_cache()
    for fill in (0xFFFF, -(1 << 25)):
        parts = [torch.full((64, 2048), fill, dtype=torch.int32, device=dev) for _ in PRIMES_PAIR]
        d = garner_pair_carry(*parts)
        identical(("garner_pair_carry", fill), d, garner_pair_carry_plain(*parts))
        assert pair_digits[0] < int(d.min()) and int(d.max()) < pair_digits[1], fill
        print(f"garner_pair_carry 5 x (64, 2048) all {fill:#x}: identical to its plain version; "
              f"digits in [{int(d.min())}, {int(d.max())}]")
    del parts, d
    print(f"pair links: {time.perf_counter() - t_pair:.1f} s")

    # 2. the products: the hook's cells recorded at each staged chunk
    cells = []
    real_post = mm.garner_post

    def spy_post(*args):
        ctx = real_post(*args)

        class Rec:
            def __enter__(self):
                cells.append(ctx.__enter__())
                return cells[-1]

            def __exit__(self, *exc):
                return ctx.__exit__(*exc)

        return Rec()

    pair_expect = ("pair_input_planes", "mid_planes", "garner_pair_carry", "int8_gemm",
                   "canonicalize")
    pair_forbid = ("input_planes", "garner_carry", "garner_carry_post", "garner_residues",
                   "garner_residues_post", "ntt4_input_planes", "conv_base")

    def pair_checks(label, staged, n_cells=None):
        """After a run under the tier: the pair links at all five primes,
        the hook asked (staged; n_cells times where given) and never
        consumed.  Returns the launches by prime and the hook's asks."""
        by_prime = {p: c for p, c in kernels.MID_PLANES_BY_PRIME.items() if c}
        assert set(by_prime) == set(PRIMES_PAIR), (label, by_prime)
        assert not any(c["consumed"] for c in cells), (label, "the hook was consumed")
        assert bool(cells) == staged and n_cells in (None, len(cells)), (label, len(cells))
        return by_prime, len(cells)

    def unset_checks(label, earlier, n_cells):
        """After the same run unset: the launches of the earlier default
        run, the hook consumed as often as it was asked under the tier."""
        assert launch_log[label] == launch_log[earlier], (label, earlier)
        assert all(c["consumed"] for c in cells) and len(cells) == n_cells, label
        assert {p for p, c in kernels.MID_PLANES_BY_PRIME.items() if c} == set(PRIMES), label

    mm.garner_post = spy_post
    try:
        # mul/sqr at 10^7 and 10^8 and mulmod_int at 2^22, through the entry
        # points, under the tier and unset; each checked
        for label, bits, n, staged in (("mul/sqr 1e7", ODD_BITS, 4, False),
                                       ("mul/sqr 1e8", REC_BITS, 2, True),
                                       (f"mulmod_int 2^{MULMOD_N[0].bit_length() - 1}",
                                        MULMOD_N[0], 0, False)):
            if n == 0:
                x, y = rnd.randrange((1 << bits) + 1), rnd.randrange((1 << bits) + 1)
                want = mod_fermat(x * y, bits)
                how = "Python's product, folded"

                def run():
                    assert mulmod_int(x, y, bits) == want, label
            else:
                x, y = operand(bits), operand(bits)
                how = f"residues mod {n} 61-bit primes"

                def run():
                    pr, sq = mul(x, y), sqr(x)
                    assert residues_agree(pr, x, y, primes[:n]), f"pair mul {label}"
                    assert residues_agree(sq, x, x, primes[:n]), f"pair sqr {label}"
            cells.clear()
            with pair_tier():
                counted(f"{label} (pair tier)", pair_expect + (("ladder",) if staged else ()),
                        run, pair_forbid)
            by_prime, n_cells = pair_checks(label, staged)
            cells.clear()
            with pair_tier(False):
                counted(f"{label} (unset)", (), run)
            unset_checks(f"{label} (unset)", label, n_cells)
            print(f"{label} (pair tier): exact ({how}); mid_planes launches by prime "
                  f"{json.dumps(by_prime)}; the hook "
                  f"{f'asked {n_cells} times, never consumed' if staged else 'not asked'}; "
                  f"unset: the launches of the default run above, the hook consumed")
        # 10^9: mul() under the tier (staged, 4 chunks), its product by one
        # residue (a 61-bit residue of a 2x10^9-bit int costs the host 2 s);
        # then mul and sqr as mul() / sqr() run them on the card's digits
        # (the same launches, no host conversion), under the tier and unset:
        # the products identical, the unset launches the default run's
        x, y = operand(HUGE_BITS), operand(HUGE_BITS)
        q = primes[0]
        rx, ry = x % q, y % q
        cells.clear()
        with pair_tier():
            pr = counted("mul 1e9 (pair tier)", pair_expect + ("ladder",), lambda: mul(x, y),
                         pair_forbid)
        assert pr % q == rx * ry % q and pr.bit_length() in (2 * HUGE_BITS - 1, 2 * HUGE_BITS)
        del pr
        by_prime, n_cells = pair_checks("mul 1e9", True)
        hplan = choose_params(HUGE_BITS, HUGE_BITS, sqrt2=True)
        st9 = _staged_flagship(hplan)
        dx9, dy9 = on_card(x, HUGE_BITS), on_card(y, HUGE_BITS)
        del x, y
        cells.clear()
        with pair_tier():
            got = counted("mul/sqr 1e9 on the card's digits (pair tier)",
                          pair_expect + ("ladder",), lambda: (st9(dx9, dy9), st9(dx9)),
                          pair_forbid)
        pair_checks("mul/sqr 1e9", True, 2 * n_cells)
        cells.clear()
        with pair_tier(False):
            want = counted("mul/sqr 1e9 on the card's digits (unset)", (),
                           lambda: (st9(dx9, dy9), st9(dx9)))
        unset_checks("mul/sqr 1e9 on the card's digits (unset)", "mul/sqr 1e9", 2 * n_cells)
        identical("mul 1e9 pair tier", got[0], want[0])
        identical("sqr 1e9 pair tier", got[1], want[1])
        del got, want
        print(f"mul 1e9 (pair tier): exact (residue mod a 61-bit prime), the hook asked "
              f"{n_cells} times, never consumed; mul and sqr on the card's digits identical to "
              f"the dense tier's, mid_planes launches by prime {json.dumps(by_prime)}; unset: "
              f"the launches of the default run above, the hook consumed")
    finally:
        mm.garner_post = real_post

    # 3. the A/B (a record, not a claim): the pointwise chunk of the 10^8 and
    #    10^9-bit plans, pair against dense, then the staged products
    for tag, pB, pM in (("1e8", 32768, 1024), ("1e9", 32768, 2048)):
        prof = profile_pointwise(pB, pM, 10, pair=True)
        e2e[f"pair_pointwise_{tag}"] = prof
        print(f"pointwise ({pB}, {pM}) split (utils/prof_pointwise, ms, median of 10): "
              + json.dumps(prof))
        for tier, pre, n in (("dense", "", 3), ("pair", "pair_", 5)):
            fwd, inv = f"{pre}fwd_gemms_x{2 * n}", f"{pre}inv_gemms_x{n}"
            gemm = prof[fwd] + prof[inv]
            links = prof[f"{pre}input_planes_x2"] + prof[f"{pre}mid_planes_x{n}"]
            print(f"  {tier} tier at ({pB}, {pM}): GEMMs {gemm:.3f} ms (forward "
                  f"{prof[fwd + '_int8_ops_per_s'] / 1e12:.1f} x 10^12 int8 ops/s, "
                  f"{prof[fwd + '_int8_share']:.1%} of 1979 x 10^12; inverse "
                  f"{prof[inv + '_int8_ops_per_s'] / 1e12:.1f} x 10^12, "
                  f"{prof[inv + '_int8_share']:.1%}), links {links:.3f} ms (input planes "
                  f"{prof[f'{pre}input_planes_x2_bytes_share']:.1%} of their bytes bound, "
                  f"mid_planes {prof[f'{pre}mid_planes_x{n}_bytes_share']:.1%}), Garner "
                  f"{prof[f'{pre}garner']:.3f} ms ({prof[f'{pre}garner_bytes_share']:.1%}); "
                  f"whole {prof['pair_full' if pre else 'mulmod_ntt_full']:.3f} ms")
        print(f"pointwise ({pB}, {pM}) A/B, interleaved P, D, D, P, 20 calls each: pair "
              f"{prof['ab_pair_ms']:.3f} ms, dense {prof['ab_dense_ms']:.3f} ms "
              f"({prof['ab_dense_ms'] / prof['ab_pair_ms']:.3f}x)")
        torch.cuda.empty_cache()
    st8 = _staged_flagship(choose_params(REC_BITS, REC_BITS, sqrt2=True))
    staged_ops = {"1e8": (st8, on_card(operand(REC_BITS), REC_BITS),
                          on_card(operand(REC_BITS), REC_BITS)),
                  "1e9": (st9, dx9, dy9)}
    del st9, dx9, dy9
    for tag in ("1e8", "1e9"):
        st, dx, dy = staged_ops.pop(tag)

        def on_pair():
            with pair_tier():
                return st(dx, dy)

        identical(("staged pair", tag), on_pair(), st(dx, dy))
        p_ms, d_ms = ab_ms(on_pair, lambda: st(dx, dy), 5, warm=False)
        e2e[f"mul_{tag}_pair_device_ms"], e2e[f"mul_{tag}_dense_device_ms"] = p_ms, d_ms
        print(f"mul {tag} staged A/B (record, not a claim; device ms interleaved, 10 calls "
              f"each): pair tier {p_ms:.3f}, dense {d_ms:.3f}; digits identical")
        del dx, dy, st
        torch.cuda.empty_cache()
    print(f"pair phase: {time.perf_counter() - t_pair:.1f} s")

    # #9's counterpart: no path of either package reaches the reference's
    # fused(fn, x) (its one caller, maybe_fused, has no caller), so the
    # whole-block transform is driven here through its own entry point, a
    # forward and an inverse of the largest block, counted
    bC, bL = FUSED_BLOCKS[1]
    bW = DIGIT_BITS * bL
    xb = rand((bC, bL), -(1 << 16), 1 << 16)
    back = counted(f"fused ({bC}, {bL}) forward + inverse", ("fused",),
                   lambda: fused("inv", fused("fwd", xb, 2 * bW // bC, bW), 2 * bW // bC, bW),
                   ("mfa_cols", "ladder", "ladder_pe", "transform_small"))
    # the inverse of the forward is C times the block (mod 2^W + 1)
    assert torch.equal(canon(back), canon(xb * bC)), "fused: inverse of forward"
    print(f"fused ({bC}, {bL}): the inverse of the forward is {bC} x the block, after normmod")

    # the out-of-core engine's passes at small plans with 64 KB chunks
    # (several a pass; odd w with t > h, and even w): each pass's packed
    # output on the card identical to the same engine's on the host, where
    # every kernel's plain version runs
    for hb, hd in ((100_000, 7), (150_000, 7)):
        hp = plan_for_depth(hb, hb, hd, sqrt2=True)
        hx, hy = operand(hb), operand(hb)
        hdx, hdy = on_card(hx, hb), on_card(hy, hb)
        (got, got_sq), passes = huge_passes(
            lambda: (mul_huge(hdx, hdy, hp), sqr_huge(hdx, hp)), 64 << 10)
        (want, want_sq), plain = huge_passes(
            lambda: (mul_huge(hdx.cpu(), hdy.cpu(), hp), sqr_huge(hdx.cpu(), hp)), 64 << 10)
        assert len(passes) == len(plain) > 8, (hb, len(passes), len(plain))
        for (name, got_rows), (pname, want_rows) in zip(passes, plain):
            assert name == pname and len(got_rows) == len(want_rows), (hb, name)
            assert all(torch.equal(r, q) for r, q in zip(got_rows, want_rows)), (hb, name)
        assert torch.equal(got.cpu(), want) and torch.equal(got_sq.cpu(), want_sq), hb
        assert int_from_digits(want.numpy()) == hx * hy, hb
        assert int_from_digits(want_sq.numpy()) == hx * hx, hb
        print(f"mul_huge / sqr_huge {hb} bits (plan {hp.depth}/{hp.w}/{hp.W // DIGIT_BITS}, "
              f"64 KB chunks): {len(passes)} passes, each output identical to the host's "
              f"plain run; products exact (full compare)")

    # 4x10^9 bits: past 2^29 elements, mul() and sqr() run out of core (odd
    # w, trunc_mfa > h): packed stores, chunked column and row passes, the
    # 4-step pointwise per chunk; the ladder launches recorded, then each
    # shape held against ladder_plain on the card and timed
    p4 = choose_params(FOUR_BITS, FOUR_BITS, sqrt2=True)
    L4, h4 = p4.W // DIGIT_BITS, p4.conv_len // 2
    print(f"4e9 plan: {p4} L={L4} conv={p4.conv_len} trunc_mfa={p4.trunc_mfa} n1={p4.n1}")
    assert (p4.depth, p4.w, L4) == (16, 1, 4096) and p4.trunc_mfa > h4 and flagship_is_huge(p4)
    x, y = operand(FOUR_BITS), operand(FOUR_BITS)
    rx, ry = [x % q for q in primes[:2]], [y % q for q in primes[:2]]
    huge_route = ("ladder", "ladder_pe", "normmod", "twiddle_half", "canonicalize") + ntt4
    no_huge = ("sqrt2_top_fwd", "sqrt2_top_inv", "mfa_cols", "ladder_pre_half", "conv_base",
               "normmod_long", "transform_small", "transform_small_half", "input_planes",
               "mid_planes", "garner_carry") + ntt4_links + posts
    host = {}

    def run4():
        with ladder_calls() as seen:
            t = time.perf_counter()
            pr = mul(x, y)
            host["mul"] = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            sq = sqr(x)
            host["sqr"] = (time.perf_counter() - t) * 1e3
        return pr, sq, seen

    pr, sq, seen4 = counted("mul/sqr 4e9", huge_route, run4, no_huge)
    for q, a_r, b_r in zip(primes[:2], rx, ry):
        assert pr % q == a_r * b_r % q and sq % q == a_r * a_r % q, "4e9 residues"
    assert pr.bit_length() in (2 * FOUR_BITS - 1, 2 * FOUR_BITS)
    del pr, sq
    print("mul/sqr 4e9: exact (residues mod 2 61-bit primes)")
    dx, dy = on_card(x, FOUR_BITS), on_card(y, FOUR_BITS)
    del x, y
    e2e["mul_4e9_ms"], e2e["sqr_4e9_ms"] = host["mul"], host["sqr"]
    e2e["mul_4e9_device_ms"] = time_ms(lambda: mul_huge(dx, dy, p4), 1)
    e2e["sqr_4e9_device_ms"] = time_ms(lambda: sqr_huge(dx, p4), 1)
    e2e["mul_4e9_peak_gib"] = peak_gib(lambda: mul_huge(dx, dy, p4))
    e2e["sqr_4e9_peak_gib"] = peak_gib(lambda: sqr_huge(dx, p4))
    for op in ("mul", "sqr"):
        e2e[f"{op}_4e9_host_share"] = 1 - e2e[f"{op}_4e9_device_ms"] / e2e[f"{op}_4e9_ms"]
    print("4e9 times: " + json.dumps({k: v for k, v in e2e.items() if "4e9" in k}))
    del dx, dy
    torch.cuda.empty_cache()
    recs = measure_launches(seen4, rand, 3)
    for r in recs:
        add_row(r["name"], "mpir_fft_tpu_torch/csrc/ladder.cu", LADDER_REPLACES[r["name"]],
                0, r["ms"], r["plain_ms"], r["nbytes"], r["ops"])
        print(f"{r['name']} 4e9 out of core {r['kind']} {tuple(r['shape'])}: "
              f"x{r['launches']} per mul + sqr; raw digits identical; {r['ms']:.3f} ms, "
              f"{r['bound_by']} bound {r['bound_ms']:.3f} ms ({r['share']:.1%}); "
              f"plain {r['plain_ms']:.3f} ms")
    print(f"ladder 4e9 out of core: {len(recs)} shapes, "
          f"{sum(r['launches'] for r in recs)} launches per mul + sqr")
    del seen4
    torch.cuda.empty_cache()

    # 4x10^9 x 4x10^8 bits: past 2^29 elements with j1 > h, which the
    # out-of-core engine cannot take: ten balanced pieces through the staged
    # route, b converted and shipped once; each piece's driver call timed
    pp = choose_params(*PIECES, sqrt2=True)
    print(f"4e9x4e8 plan: {pp} L={pp.W // DIGIT_BITS}; taken as balanced pieces")
    assert _piecewise_serves(pp)
    x, y = operand(PIECES[0]), operand(PIECES[1])
    piece_ms = []
    real_driver = mm._driver

    def timed_driver(kind, dplan):
        run = real_driver(kind, dplan)

        def go(da, db):
            out, ms = timed(lambda: run(da, db))
            piece_ms.append(ms)
            return out
        return go

    mm._driver = timed_driver
    try:
        t = time.perf_counter()
        pr = counted("mul 4e9x4e8 (pieces)", zerotop + ("normmod",) + ntt_post,
                     lambda: mul(x, y), no_top + ("mfa_cols", "ladder_pe"))
        e2e["mul_4e9x4e8_ms"] = (time.perf_counter() - t) * 1e3
    finally:
        mm._driver = real_driver
    assert len(piece_ms) == cdiv(PIECES[0], PIECES[1]) == 10, len(piece_ms)
    assert residues_agree(pr, x, y, primes[:2]), "4e9x4e8 residues"
    del pr, x, y
    e2e["mul_4e9x4e8_pieces"] = len(piece_ms)
    e2e["mul_4e9x4e8_device_ms"] = sum(piece_ms)
    e2e["mul_4e9x4e8_host_share"] = 1 - sum(piece_ms) / e2e["mul_4e9x4e8_ms"]
    print("mul 4e9x4e8: exact (residues mod 2 61-bit primes); "
          + json.dumps({k: v for k, v in e2e.items() if "4e9x4e8" in k}))

    # mul_many: the batch cells, one driver call a batch; every product
    # equal to a loop of mul's and held by residues, the 10^6-bit batch and
    # the first 10^7-bit pair against Python's products (full compare: a
    # 10^7-bit Python product takes seconds); record beside the loop of mul
    # (host clock) and of the driver (device)
    for bits, n in MANY:
        label = f"{bits:.0e}x{n}"
        bp = choose_params(bits, bits, sqrt2=True)
        assert not flagship_is_staged(bp), bp
        pairs = [(operand(bits), operand(bits)) for _ in range(n)]
        got = counted(f"mul_many {label}", odd_ntt if bp.w % 2 else even_ntt,
                      lambda: mul_many(pairs), no_school + no_mfa)
        assert got == [mul(a, b) for a, b in pairs], f"mul_many {label}"
        assert all(residues_agree(v, a, b, primes) for v, (a, b) in zip(got, pairs)), label
        full = pairs if bits <= MANY[0][0] else pairs[:1]
        assert got[:len(full)] == [a * b for a, b in full], f"mul_many {label}"
        e2e[f"mul_many_{label}_ms_per_product"] = wall_ms(lambda: mul_many(pairs), 3) / n
        e2e[f"mul_loop_{label}_ms_per_product"] = wall_ms(
            lambda: [mul(a, b) for a, b in pairs], 1) / n
        Lb = cdiv(bits, DIGIT_BITS)
        da = torch.stack([on_card(a, bits) for a, _ in pairs])
        db = torch.stack([on_card(b, bits) for _, b in pairs])
        e2e[f"mul_many_{label}_device_ms_per_product"] = time_ms(
            lambda: mpn_mul_flagship(da, db, bp), 3) / n
        e2e[f"mul_loop_{label}_device_ms_per_product"] = time_ms(
            lambda: [mpn_mul_flagship(da[i], db[i], bp) for i in range(n)], 3) / n
        assert da.shape == (n, Lb)
        print(f"mul_many {label} (plan {bp.depth}/{bp.w}/{bp.W // DIGIT_BITS}): exact (equal "
              f"to mul's, residues; full compare of {len(full)}); "
              + json.dumps({k: v for k, v in e2e.items() if label in k}))
        del da, db

    # the tools around mul(): the CLI's subcommands in process on the
    # card, each counted; files in a temporary directory, the tuner's cache
    # there too (MPIR_FFT_TUNE_CACHE for the tune subcommand only)
    from mpir_fft_tpu_torch import cli, native

    t_tools = time.perf_counter()
    tools_dir = tempfile.TemporaryDirectory()
    tdir = pathlib.Path(tools_dir.name)

    def cli_run(label, argv, expect=()):
        """cli.main(argv) counted; its output printed; rc must be 0."""
        out = io.StringIO()

        def go():
            with contextlib.redirect_stdout(out):
                return cli.main(argv)

        rc = counted(f"cli {label}", expect, go)
        print("\n".join(f"  {line}" for line in out.getvalue().splitlines()))
        assert rc == 0, f"cli {label}: exit code {rc}"
        return out.getvalue().splitlines()

    gmp_ok = native.gmp_mul(b"\x03", b"\x05") == b"\x0f\x00"
    print(f"GMP (libgmp.so.10 through cc): {'available' if gmp_ok else 'not available'}")
    cli_run("selftest 2e5", ["selftest", "--bits", "200000"], ("canonicalize",))
    for bits, label, expect in ((ODD_BITS, "1e7", odd_ntt),
                                (REC_BITS, "1e8", zerotop + ("normmod",) + ntt_post)):
        x, y = operand(bits), operand(bits)
        xb, yb = x.to_bytes(bits // 8, "little"), y.to_bytes(bits // 8, "little")
        (tdir / "a.bin").write_bytes(xb)
        (tdir / "b.bin").write_bytes(yb)
        cli_run(f"mul {label}", ["mul", str(tdir / "a.bin"), str(tdir / "b.bin"),
                                 str(tdir / "out.bin")], expect)
        got = (tdir / "out.bin").read_bytes()
        assert len(got) == 2 * cdiv(2 * bits, DIGIT_BITS) + 4, (label, len(got))
        want = native.gmp_mul(xb, yb)
        if want is not None:
            assert got == want + bytes(len(got) - len(want)), f"cli mul {label}"
            how = "equal to GMP's mpn_mul"
        else:
            assert residues_agree(int.from_bytes(got, "little"), x, y, primes), label
            how = "residues mod 4 61-bit primes"
        print(f"cli mul {label}: the product file ({len(got)} bytes) {how}")
    N = MULMOD_N[0]
    x, y = rnd.randrange((1 << N) + 1), rnd.randrange((1 << N) + 1)
    (tdir / "a.bin").write_bytes(x.to_bytes(N // 8 + 1, "little"))
    (tdir / "b.bin").write_bytes(y.to_bytes(N // 8 + 1, "little"))
    cli_run("mulmod 2^22", ["mulmod", str(tdir / "a.bin"), str(tdir / "b.bin"),
                            str(tdir / "out.bin"), "--nbits", str(N)], rec_flat_ntt)
    got = int.from_bytes((tdir / "out.bin").read_bytes(), "little")
    assert got == mod_fermat(x * y, N), "cli mulmod 2^22"
    print("cli mulmod 2^22: equal to Python's product folded mod 2^N+1")
    os.environ["MPIR_FFT_TUNE_CACHE"] = str(tdir / "tune.json")
    try:
        for bits, label in ((ODD_BITS, "1e7"), (REC_BITS, "1e8")):
            entry = json.loads(cli_run(f"tune {label}", ["tune", "--bits", str(bits)],
                                       ("ladder", "canonicalize", "int8_gemm"))[-1])
            assert not entry["cached"] and entry["device"] == torch.cuda.get_device_name(0)
            for d, w, *r in entry["candidates"]:
                print(f"  tune {label}: depth {d} w {w}: " + (
                    f"median {r[0]:.4f} ms, spread {r[1]:.4f} ms" if len(r) == 2 else r[0]))
            print(f"tune {label}: kept depth {entry['depth']} w {entry['w']} "
                  f"({entry['ms']:.4f} ms); analytic {entry['analytic']}")
    finally:
        del os.environ["MPIR_FFT_TUNE_CACHE"]
    for bits, label in ((REC_BITS, "1e8"), (HUGE_BITS, "1e9")):
        prof = json.loads(cli_run(f"profile --stages {label}", ["profile", "--bits", str(bits)],
                                  zerotop + ntt_post)[-1])
        ratio = prof["total_s"] / prof["route_s"]
        print(f"profile {label}: stages sum {prof['total_s'] * 1e3:.3f} ms, route "
              f"{prof['route_s'] * 1e3:.3f} ms, ratio {ratio:.3f}")
        assert 0.8 <= ratio <= 1.5, (label, ratio)
    cli_run("profile --transforms 12/1", ["profile", "--transforms", "--depth", "12", "--w",
                                          "1"], ("ladder", "sqrt2_top_fwd", "sqrt2_top_inv"))
    if gmp_ok:
        cli_run("baseline 1e7", ["baseline", "--bits", str(ODD_BITS)])
    else:
        print("baseline 1e7: GMP is missing on this machine (cli baseline exits 1)")
    tools_dir.cleanup()
    print(f"tools phase (cli): {time.perf_counter() - t_tools:.1f} s")

    # -- the sharded phase: parallel/ on ranks sharing the card ----------------
    # The kernels are built above, so no rank builds them again; the ranks
    # start by spawn (CUDA is initialised here), join one gloo group through
    # a FileStore, and each runs utils/shard_bench.rank_phase on the same
    # seeded operands: each product checked, then timed (CUDA events), its
    # exchanges counted and the rank's peak memory read.  Here: every rank's
    # residues equal, and equal to the operands' product mod the primes; the
    # digits up to 10^8 bits equal GMP's product where GMP is present; every
    # kernel of SHARD_KERNELS launched on some rank; rank 0's ladder shapes
    # held against ladder_plain and timed.  Then NCCL at a world size of 1
    # (device tensors), and what NCCL answers two ranks on one card.
    from mpir_fft_tpu_torch.parallel.dryrun import exchange_check, run_ranks
    from mpir_fft_tpu_torch.utils.shard_bench import operand_digits, rank_phase, residues

    t_shard = time.perf_counter()
    kernels.reset_launches()
    ranks = run_ranks(SHARD_RANKS, rank_phase,
                      (SHARD_SPECS, SEED, primes[:2], SHARD_FULL_BITS),
                      device="cuda", backend="gloo", timeout=900)
    shard_s = time.perf_counter() - t_shard
    exch_ms = 0.0
    for i, (label, route, ba, bb, depth, pairs) in enumerate(SHARD_SPECS):
        base = SEED + 1000 * i
        if route == "many":
            ops = [(operand_digits(ba, base + 2 * j), operand_digits(bb, base + 2 * j + 1))
                   for j in range(pairs)]
        else:
            ops = [(operand_digits(ba, base), operand_digits(bb, base + 1))]
        for name in ("mul", "sqr"):
            if name not in ranks[0][label]:
                continue
            pairs_d = ops if name == "mul" else [(ops[0][0], ops[0][0])]
            want = [[ra * rb % q for ra, rb, q in zip(residues(da, primes[:2]),
                                                      residues(db, primes[:2]), primes[:2])]
                    for da, db in pairs_d]
            for r in ranks:
                assert tuple(r[label]["plan"]) == SHARD_PLANS[label], (label, r[label]["plan"])
                assert r[label][name]["residues"] == want, (label, name, r["rank"])
            how = f"residues mod {len(primes[:2])} 61-bit primes on {len(ranks)} ranks"
            got = ranks[0][label][name].get("digits")
            if got is not None and gmp_ok and route == "mul":
                xb = pairs_d[0][0].astype("<u2").tobytes()
                yb = pairs_d[0][1].astype("<u2").tobytes()
                gb = native.gmp_mul(xb, yb)
                pb = got.astype("<u2").tobytes()
                assert pb[:len(gb)] == gb and not any(pb[len(gb):]), (label, name)
                how += "; digits equal to GMP's mpn_mul"
            per = [r[label][name] for r in ranks]
            exch_ms += sum(p["exchanges"]["ms"] for p in per) / len(per)
            rec = {"device_ms": [round(p["device_ms"], 3) for p in per],
                   "exchange_ms": [round(p["exchanges"]["ms"], 3) for p in per],
                   "exchanges": {k: per[0]["exchanges"][k]
                                 for k in ("all_to_all", "all_gather", "bytes")},
                   "peak_gib": [round(p["peak_gib"], 3) for p in per]}
            e2e[f"sharded_{name}_{label}"] = rec
            print(f"sharded {name} {label} (plan {ranks[0][label]['plan']}, {SHARD_RANKS} gloo "
                  f"ranks on cuda:0, transport {ranks[0]['transport']}): exact ({how}); "
                  + json.dumps(rec))
    # the row passes of the sharded 10^8 and 6.3x10^7 x 5x10^6 products: a
    # rank's (128, 1024) / (128, 512) rows, which the reference fuses, on the
    # whole-row transform (clusters) on every rank
    for label in ("1e8", "6.3e7x5e6"):
        for r in ranks:
            assert r[label]["mul"]["launches"]["transform_small"] > 0, (label, r["rank"])
    shard_launches = {k: sum(r["launches"][k] for r in ranks) for k in kernels.LAUNCHES}
    for name, n in shard_launches.items():
        launches_total[name] += n
    print(f"sharded launches (summed over the ranks): "
          f"{json.dumps({k: n for k, n in shard_launches.items() if n})}")
    for name in SHARD_KERNELS:
        assert shard_launches[name] > 0, f"sharded phase: kernel {name} launched on no rank"
    print(f"sharded phase (gloo, {SHARD_RANKS} ranks): {shard_s:.1f} s, of which the timed "
          f"runs' exchanges {exch_ms / 1e3:.1f} s a rank")
    # rank 0's ladder launch shapes on the sharded path (the full MFA columns
    # on the recursion with their cross tables at L 1024 / 2048, the rows):
    # raw digits against ladder_plain on the card, timed
    seen_sh = {k: [c, st, Wk, None if pe is None else torch.from_numpy(pe).to(dev), pre]
               for k, (c, st, Wk, pe, pre) in ranks[0]["ladder"].items()}
    for r in measure_launches(seen_sh, rand, 3):
        add_row(r["name"], "mpir_fft_tpu_torch/csrc/ladder.cu", LADDER_REPLACES[r["name"]],
                0, r["ms"], r["plain_ms"], r["nbytes"], r["ops"])
        print(f"{r['name']} sharded {r['kind']} {tuple(r['shape'])}: x{r['launches']} on rank 0; "
              f"raw digits identical; {r['ms']:.3f} ms, {r['bound_by']} bound "
              f"{r['bound_ms']:.3f} ms ({r['share']:.1%}); plain {r['plain_ms']:.3f} ms")
    del seen_sh, ranks
    torch.cuda.empty_cache()
    # the column kernel on a rank's block: the 10^7 plan's columns [16, 32)
    # of n1 64 (rank 1 of 4), both halves, at global column offset 16
    sp7 = choose_params(ODD_BITS, ODD_BITS, sqrt2=True)
    cW7, cL7 = sp7.W, sp7.W // DIGIT_BITS
    nl7 = sp7.n1 // SHARD_RANKS
    xin = rand((2 * nl7, sp7.n2, cL7), -(1 << 17), 1 << 17)
    for kind in ("fwd", "inv"):
        blk = (nl7, nl7)
        got = fused_mfa_cols(kind, xin, sp7.w, cW7, sp7.n1, sp7.n2, False, blk)
        t0 = time.perf_counter()
        want = mfa_cols_plain(kind, xin.cpu(), sp7.w, cW7, sp7.n1, sp7.n2, False, blk)
        pms = (time.perf_counter() - t0) * 1e3
        identical(("mfa_cols block", kind), got.cpu(), want)
        ms = time_ms(lambda: fused_mfa_cols(kind, xin, sp7.w, cW7, sp7.n1, sp7.n2, False, blk),
                     10, 2)
        ops = mfa_cols_ops(mfa_cols_schedule(kind, sp7.n2, sp7.w * sp7.n1, sp7.n2, False),
                           2 * nl7, cL7)
        add_row("mfa_cols", "mpir_fft_tpu_torch/csrc/mfa_cols.cu",
                "mpir_fft_tpu/ops/fused.py:200", 0, ms, pms, 8 * xin.numel(), ops)
        print(f"mfa_cols sharded block {kind} {tuple(xin.shape)} columns [{nl7}, {2 * nl7}) of "
              f"{sp7.n1}: raw digits identical; {ms:.4f} ms (plain, on the host CPU, "
              f"{pms:.1f} ms)")
        xin = got
    del xin, got, want
    # NCCL at a world size of 1: the 10^9-bit staged product on device
    # tensors through NCCL's own exchanges, equal to the gloo ranks'
    t0 = time.perf_counter()
    (one,) = run_ranks(1, rank_phase, (SHARD_SPECS[2:3], SEED + 2000, primes[:2],
                                       SHARD_FULL_BITS), device="cuda", backend="nccl", timeout=600)
    assert one["backend"] == "nccl" and one["transport"] == "device", one["backend"]
    for name in ("mul", "sqr"):
        want = e2e[f"sharded_{name}_1e9"]
        assert one["1e9"][name]["residues"] == [[ra * rb % q for ra, rb, q in zip(
            residues(operand_digits(HUGE_BITS, SEED + 2000), primes[:2]),
            residues(operand_digits(HUGE_BITS, SEED + 2000 + (1 if name == "mul" else 0)),
                     primes[:2]), primes[:2])]], ("nccl", name)
        rec = one["1e9"][name]
        e2e[f"sharded_nccl_{name}_1e9"] = {
            "device_ms": rec["device_ms"], "exchange_ms": rec["exchanges"]["ms"],
            "exchanges": {k: rec["exchanges"][k] for k in ("all_to_all", "all_gather", "bytes")},
            "peak_gib": rec["peak_gib"]}
        print(f"sharded {name} 1e9, NCCL, one rank (transport {one['transport']}): exact "
              f"(residues, as the gloo ranks'); "
              + json.dumps(e2e[f"sharded_nccl_{name}_1e9"]) + f"; gloo x4: {json.dumps(want)}")
    for name, n in one["launches"].items():
        launches_total[name] += n
    print(f"NCCL world size 1: {time.perf_counter() - t0:.1f} s")
    # what NCCL answers two ranks on one card
    try:
        run_ranks(2, exchange_check, (), device="cuda", backend="nccl", timeout=180)
        print("NCCL, two ranks on cuda:0: accepted")
    except RuntimeError as err:
        if "Duplicate GPU" not in str(err):
            raise
        line = next(ln for ln in str(err).splitlines() if "Duplicate GPU" in ln)
        print(f"NCCL, two ranks on cuda:0: refused: {line.strip()}")
    print(f"sharded phase, all: {time.perf_counter() - t_shard:.1f} s")

    print("e2e (mul/sqr/mulmod: host clock incl. digit conversion; *_device: CUDA "
          "events, digits on the card): " + json.dumps(e2e))
    print("staged A/B (record, not a claim; device ms interleaved, peak GiB of one call): "
          + json.dumps(ab_staged))
    print(f"launches on the main path (all sizes): {launches_total}")
    for name, n in launches_total.items():
        assert n > 0, f"kernel {name} was not launched on the main path"

    # -- 5. report ------------------------------------------------------------
    table = []
    for r in rows.values():
        bms, by = bound(r["nbytes"], r["ops"], r["ops_per_s"])
        table.append(dict(name=r["name"], route=r["route"], source=r["source"],
                          replaces=r["replaces"], launches=launches_total[r["counter"]],
                          max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                          bound_ms=bms, bound_by=by, library_ms=r["library_ms"],
                          **{k: r[k] for k in ("ab", "ab_ms", "wide_ms") if k in r}))
    assert {r["counter"] for r in rows.values()} == set(kernels.LAUNCHES)
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
