"""Micro-profiler for the NTT-CRT pointwise chunk (the counterpart of the
reference's tools/prof_pointwise.py): one chunk's time split into its
GEMMs, its link kernels and Garner, so that work lands where the
milliseconds are.  The default shape is the 10^9-bit staged flagship's
pointwise chunk, (32768, 2048) digit rows.

    python -m mpir_fft_tpu_torch.utils.prof_pointwise [B] [M] [reps] [--ab4] [--pair]
        [--device cpu]

Rows (ms, the median of reps calls after one warm-up; CUDA events on the
card, the host clock on the CPU), on rows of B products of M digits:
  * the dense tier: mulmod_ntt_full (the whole pointwise), input_planes_x2
    (both operands), fwd_gemms_x6, mid_planes_x3, inv_gemms_x3, garner, and
    sum_parts_ms;
  * --ab4 (at M 2048, the dense tier's widest ring): mulmod_ntt_4step, the
    same rings through the 4-step tier's linked route (its primes and three
    planes; the module's TIER1_MAX_M lowered for the call, as the
    reference's tool does);
  * --pair (where ops/ntt.pair_supported(M)): the pair tier's split, the
    same rows with a pair_ prefix (input planes of both operands, ten
    forward GEMMs [B, M] @ [M, M], five mid_planes, five inverse GEMMs,
    garner_pair_carry), and ab_pair_ms / ab_dense_ms, the two whole
    pointwise products timed interleaved (pair, dense, dense, pair; reps
    rounds).
Beside each link its bytes (inputs read once, outputs written once) and
its share of that bytes bound at HBM_BYTES_PER_S; beside each GEMM row its
int8 operations a second and their share of INT8_OPS_PER_S (utils/profile).

Each row's inputs are the real outputs of the step before it, from two
independently drawn operands: both sides of a GEMM, and the three (five)
primes' spectra Garner folds, are distinct data (the reference's tool draws
them so because XLA's CSE would fold equal subexpressions; eager torch has
none, but the data stay those of a real product)."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics

import numpy as np
import torch

from mpir_fft_tpu_torch import kernels
from mpir_fft_tpu_torch.ops import ntt
from mpir_fft_tpu_torch.utils.profile import HBM_BYTES_PER_S, INT8_OPS_PER_S, gpu_line
from mpir_fft_tpu_torch.utils.transform_bench import ab_ms
from mpir_fft_tpu_torch.utils.tune import timed_ms


def _ms(fn, reps: int, dev: torch.device) -> float:
    """Median ms of fn() over reps calls after one warm-up."""
    fn()
    return statistics.median(timed_ms(fn, dev)[1] for _ in range(reps))


@contextlib.contextmanager
def env(name: str, value: str | None):
    """The environment variable `name` set to `value` (None: unset),
    restored after."""
    old = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def pair_tier(on: bool = True):
    """MPIR_FFT_NTT_PAIR set to 1 (on) or unset, restored after."""
    return env("MPIR_FFT_NTT_PAIR", "1" if on else None)


def _link(out: dict, name: str, ms: float, nbytes: float) -> None:
    out[name] = ms
    out[f"{name}_bytes"] = nbytes
    out[f"{name}_bytes_share"] = nbytes / HBM_BYTES_PER_S * 1e3 / ms


def _gemm(out: dict, name: str, ms: float, ops: float) -> None:
    out[name] = ms
    out[f"{name}_int8_ops_per_s"] = ops / ms * 1e3
    out[f"{name}_int8_share"] = ops / ms * 1e3 / INT8_OPS_PER_S


def split(a: torch.Tensor, b: torch.Tensor, reps: int, pair: bool = False) -> dict:
    """One tier's rows on operands a, b (B, M): the dense tier's (M <=
    2048), or the pair tier's (pair_supported(M)), their names prefixed
    pair_.  Bytes a digit: the input planes 10 / 9 an operand, mid_planes
    18 / 9 a prime, Garner 28 / 24."""
    B, M = a.shape
    dev = a.device
    if pair:
        pre, blocks, planes, garner, K = "pair_", ntt._pair_blocks(M, dev), \
            ntt.pair_input_planes, ntt.garner_pair_carry, M
        plane_b, mid_b, garner_b = 9, 9, 24
    else:
        pre, blocks, planes, garner, K = "", ntt._blocks(M, dev), ntt.input_planes, \
            ntt.garner_carry, 2 * M
        plane_b, mid_b, garner_b = 10, 18, 28
    n = len(blocks)
    gemm = 2 * B * K * K
    with pair_tier(pair):
        out = {f"{pre or 'mulmod_ntt_'}full": _ms(lambda: ntt.mulmod_ntt(a, b), reps, dev)}
    _link(out, f"{pre}input_planes_x2", _ms(lambda: (planes(a), planes(b)), reps, dev),
          2 * plane_b * B * M)
    pa, pb = planes(a), planes(b)
    _gemm(out, f"{pre}fwd_gemms_x{2 * n}", _ms(lambda: [ntt._dot_raw(q[i], F) for i, (_, F, _)
                                                        in enumerate(blocks) for q in (pa, pb)],
                                               reps, dev), 2 * n * gemm)
    S = [(ntt._dot_raw(pa[i], F), ntt._dot_raw(pb[i], F)) for i, (_, F, _) in enumerate(blocks)]
    del pa, pb
    _link(out, f"{pre}mid_planes_x{n}", _ms(lambda: [ntt.mid_planes(sa, sb, p) for (sa, sb),
                                                     (p, _, _) in zip(S, blocks)], reps, dev),
          n * mid_b * B * M)
    pp = [ntt.mid_planes(sa, sb, p) for (sa, sb), (p, _, _) in zip(S, blocks)]
    del S
    _gemm(out, f"{pre}inv_gemms_x{n}", _ms(lambda: [ntt._dot_raw(q, G) for q, (_, _, G) in
                                                    zip(pp, blocks)], reps, dev), n * gemm)
    parts = [ntt._dot_raw(q, G) for q, (_, _, G) in zip(pp, blocks)]
    del pp
    _link(out, f"{pre}garner", _ms(lambda: garner(*parts), reps, dev), garner_b * B * M)
    out[f"{pre}sum_parts_ms"] = sum(out[k] for k in (
        f"{pre}input_planes_x2", f"{pre}fwd_gemms_x{2 * n}", f"{pre}mid_planes_x{n}",
        f"{pre}inv_gemms_x{n}", f"{pre}garner"))
    return out


def ab_4step_ms(a: torch.Tensor, b: torch.Tensor, reps: int) -> float:
    """mulmod_ntt on rings of M = 2048 digits through the 4-step tier's
    linked route (MPIR_FFT_NTT_FUSED=0: the fused kernel serves M 4096 and
    8192 only)."""
    saved = ntt.TIER1_MAX_M
    ntt.TIER1_MAX_M = a.shape[1] // 2
    try:
        with env("MPIR_FFT_NTT_FUSED", "0"):
            return _ms(lambda: ntt.mulmod_ntt(a, b), reps, a.device)
    finally:
        ntt.TIER1_MAX_M = saved


def operands(B: int, M: int, device, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independently drawn (B, M) rows of canonical digits."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(0, 1 << 16, (B, M), dtype=np.int32)).to(device)
                 for _ in range(2))


def profile_pointwise(B: int = 32768, M: int = 2048, reps: int = 8, ab4: bool = False,
                      pair: bool = False, device="cuda") -> dict:
    """The rows of the module docstring for (B, M) on `device`, one dict."""
    dev = torch.device(device)
    a, b = operands(B, M, dev)
    with pair_tier(False):
        out = {"B": B, "M": M, "reps": reps, "device": str(dev)}
        out.update(split(a, b, reps))
        if ab4:
            if M != ntt.TIER1_MAX_M:
                raise ValueError(f"--ab4: M={M}; the 4-step A/B runs at M {ntt.TIER1_MAX_M}")
            out["mulmod_ntt_4step"] = ab_4step_ms(a, b, reps)
        if pair:
            if not ntt.pair_supported(M):
                raise ValueError(f"--pair: M={M} is not a pair-tier ring (ntt.pair_supported)")
            out.update(split(a, b, reps, pair=True))

            def pair_full():
                with pair_tier():
                    return ntt.mulmod_ntt(a, b)

            out["ab_pair_ms"], out["ab_dense_ms"] = ab_ms(
                pair_full, lambda: ntt.mulmod_ntt(a, b), reps, device=dev)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", nargs="?", type=int, default=32768)
    ap.add_argument("M", nargs="?", type=int, default=2048)
    ap.add_argument("reps", nargs="?", type=int, default=8)
    ap.add_argument("--ab4", action="store_true", help="the same rings on the 4-step tier")
    ap.add_argument("--pair", action="store_true", help="the pair tier's split and A/B")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device != "cpu":
        kernels.lib()                   # build first: no row pays for nvcc
    print(json.dumps(profile_pointwise(args.B, args.M, args.reps, args.ab4, args.pair,
                                       args.device)), flush=True)
    if args.device != "cpu":
        print(gpu_line())


if __name__ == "__main__":
    main()
