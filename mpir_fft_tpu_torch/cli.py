"""Command-line tool of the port (counterpart of mpir_fft_tpu/cli.py):
multiply big integers from binary files, and measure, tune and profile the
multiply, on the card unless --device cpu is given.

  python -m mpir_fft_tpu_torch.cli mul a.bin b.bin out.bin [--driver flagship]
  python -m mpir_fft_tpu_torch.cli mulmod a.bin b.bin out.bin --nbits 1048576
  python -m mpir_fft_tpu_torch.cli bench --bits 10000000 [--driver flagship] [--batch k]
  python -m mpir_fft_tpu_torch.cli selftest [--bits 200000]
  python -m mpir_fft_tpu_torch.cli tune [--bits N | --sweep] [--driver flagship] [--reps 3]
  python -m mpir_fft_tpu_torch.cli profile [--bits N | --transforms --depth 12 --w 1]
  python -m mpir_fft_tpu_torch.cli baseline --bits 10000000   (GMP mpn_mul on the host)

Every subcommand takes --device (default cuda).  File format: raw
little-endian magnitude bytes (GMP mpz export order -1); `mul` writes 2
bytes a digit of the product, high zero digits included, byte for byte
the reference CLI's output.  The kernels build at their first launch; there
is no compile cache to enable (the reference's is JAX's).

`bench` prints one JSON line, the plan, the device time of mul()'s route
on digits resident on the device (CUDA events, median), the host-clock
time of mul() (or mul_many for --batch k) and whether every product is
exact, by residues modulo four 61-bit primes of its canonical digits.  It
is not the repository's benchmark."""

from __future__ import annotations

import argparse
import json
import random
import statistics
import sys
import time

import numpy as np
import torch

# the four largest primes below 2^61 (tests/test_torch_cli.py checks them)
PRIMES_61 = (2305843009213693951, 2305843009213693921, 2305843009213693907,
             2305843009213693723)


def _load_digits(path: str, device: torch.device):
    from mpir_fft_tpu_torch import native
    from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS
    from mpir_fft_tpu_torch.utils.params import cdiv

    with open(path, "rb") as f:
        buf = f.read()
    nbits = 8 * len(buf)
    return native.digits_from_bytes(buf, max(1, cdiv(nbits, DIGIT_BITS)), device), nbits


def cmd_mul(args) -> int:
    from mpir_fft_tpu_torch import native
    from mpir_fft_tpu_torch.models.mul import _driver, _select_plan

    dev = torch.device(args.device)
    da, bits_a = _load_digits(args.a, dev)
    db, bits_b = _load_digits(args.b, dev)
    run = _driver(args.driver, _select_plan(bits_a, bits_b, args.driver, dev))
    t0 = time.perf_counter()
    out = run(da, db)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    buf = native.bytes_from_digits(out)
    with open(args.out, "wb") as f:
        f.write(buf)
    print(json.dumps({"bits_a": bits_a, "bits_b": bits_b, "driver": args.driver,
                      "seconds": dt, "out_bytes": len(buf)}))
    return 0


def cmd_mulmod(args) -> int:
    """Fermat-ring product mod 2^N+1 of two binary integer files (ref
    fft_mulmod_2expp1 as a first-class API, mul_fft.c:3125-3167)."""
    from mpir_fft_tpu_torch.ops.mulmod import mulmod_int

    def _load_int(path):
        with open(path, "rb") as f:
            return int.from_bytes(f.read(), "little")

    a, b, N = _load_int(args.a), _load_int(args.b), args.nbits
    t0 = time.perf_counter()
    r = mulmod_int(a, b, N, device=args.device)
    dt = time.perf_counter() - t0
    nbytes = (N + 8) // 8 + 1   # residues reach 2^N
    with open(args.out, "wb") as f:
        f.write(r.to_bytes(nbytes, "little"))
    print(json.dumps({"nbits": N, "seconds": dt, "out_bytes": nbytes}))
    return 0


def residues(digits: torch.Tensor) -> tuple[int, ...]:
    """The value of one canonical digit vector modulo PRIMES_61; raises
    ValueError where a digit is not canonical."""
    from mpir_fft_tpu_torch import native

    v = int.from_bytes(native.bytes_from_digits(digits), "little")
    return tuple(v % p for p in PRIMES_61)


def cmd_bench(args) -> int:
    from mpir_fft_tpu_torch.models.mul import (DRIVERS, _driver, _select_plan, flagship_is_huge,
                                               flagship_is_staged, mul, mul_many)
    from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, digits_from_int
    from mpir_fft_tpu_torch.utils.params import cdiv, choose_params
    from mpir_fft_tpu_torch.utils.profile import _device_line, random_operand
    from mpir_fft_tpu_torch.utils.tune import timed_ms

    dev = torch.device(args.device)
    bits, k = args.bits, args.batch
    rnd = random.Random(bits)
    pairs = [(random_operand(rnd, bits), random_operand(rnd, bits)) for _ in range(k)]
    L = cdiv(bits, DIGIT_BITS)
    da = torch.from_numpy(np.stack([digits_from_int(a, L) for a, _ in pairs])).to(dev)
    db = torch.from_numpy(np.stack([digits_from_int(b, L) for _, b in pairs])).to(dev)
    if k == 1:      # mul()'s plan; mul_many's is the analytic one
        plan = _select_plan(bits, bits, args.driver, dev)
    else:
        plan = choose_params(bits, bits, sqrt2=DRIVERS[args.driver][1])
    run = _driver(args.driver, plan)
    if k > 1 and not (args.driver == "flagship"
                      and (flagship_is_huge(plan) or flagship_is_staged(plan))):
        def route():        # mul_many's one batched driver call
            return run(da, db)
    else:
        def route():        # one driver call a product, as mul / mul_many's loop
            return torch.stack([run(da[i], db[i]) for i in range(k)])
    out, _ = timed_ms(route, dev)
    exact = all(residues(row) == tuple(a % p * (b % p) % p for p in PRIMES_61)
                for row, (a, b) in zip(out, pairs))
    del out
    device_ms = [timed_ms(route, dev)[1] for _ in range(args.reps)]
    wall = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        if k == 1:
            mul(*pairs[0], args.driver, dev)
        else:
            mul_many(pairs, args.driver, dev)
        wall.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({
        "bits": bits, "driver": args.driver, "batch": k,
        "plan": {"depth": plan.depth, "w": plan.w, "L": plan.W // DIGIT_BITS,
                 "conv": plan.conv_len, "trunc_mfa": plan.trunc_mfa},
        "device_ms": statistics.median(device_ms), "device_ms_all": device_ms,
        "wall_ms": statistics.median(wall), "wall_ms_all": wall,
        "exact": exact, "exact_by": "residues mod four 61-bit primes of the canonical digits",
        **_device_line(dev)}))
    return 0 if exact else 1


def cmd_selftest(args) -> int:
    from mpir_fft_tpu_torch import native
    from mpir_fft_tpu_torch.models.mul import DRIVERS, mul

    rng = np.random.default_rng(0)
    bits = args.bits
    ab = rng.bytes(bits // 8)
    bb = rng.bytes(bits // 16)
    a = int.from_bytes(ab, "little") | (1 << (bits - 1))
    b = int.from_bytes(bb, "little") | (1 << (bits // 2 - 1))
    # the oracle: GMP's assembly where the native layer builds (Python's
    # multiply takes minutes from 10^8 bits)
    got = native.gmp_mul(a.to_bytes(bits // 8, "little"), b.to_bytes(bits // 16, "little"))
    if got is None:
        want, oracle = a * b, "python int multiply (GMP not available)"
    else:
        want, oracle = int.from_bytes(got, "little"), "gmp mpn_mul"
    print(f"oracle: {oracle}")
    failures = []
    for drv in DRIVERS:
        ok = mul(a, b, drv, args.device) == want
        print(f"{drv:<12} {'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(drv)
    return 1 if failures else 0


def cmd_tune(args) -> int:
    from mpir_fft_tpu_torch.models.mul import DRIVERS
    from mpir_fft_tpu_torch.utils.tune import cached_plan, tune

    sqrt2 = DRIVERS[args.driver][1]
    sizes = [10 ** e for e in (6, 7, 8, 9)] if args.sweep else [args.bits]
    for bits in sizes:
        plan = cached_plan(bits, bits, args.driver, args.device)
        if plan is not None:
            print(json.dumps({"driver": args.driver, "bits": bits, "depth": plan.depth,
                              "w": plan.w, "sqrt2": sqrt2, "cached": True}))
            continue
        entry = tune(bits, bits, args.driver, args.reps, args.device)
        print(json.dumps({"driver": args.driver, "bits": bits, "sqrt2": sqrt2, "cached": False,
                          **entry}))
    return 0


def cmd_profile(args) -> int:
    from mpir_fft_tpu_torch.utils.profile import profile_stages, profile_transforms

    if args.transforms:
        print(json.dumps(profile_transforms(args.depth, args.w, args.reps, args.batch,
                                            args.device)))
    else:
        print(json.dumps(profile_stages(args.bits, args.reps, args.driver, args.device)))
    return 0


def cmd_baseline(args) -> int:
    from mpir_fft_tpu_torch import native

    r = native.gmp_baseline(args.bits, args.reps)
    if r is None:
        print(json.dumps({"error": "gmp baseline unavailable: no cc or no libgmp.so.10"}))
        return 1
    print(json.dumps(r))
    return 0


def main(argv=None) -> int:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p = argparse.ArgumentParser(prog="mpir_fft_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("mul", parents=[common],
                       help="multiply two binary little-endian integer files")
    m.add_argument("a"), m.add_argument("b"), m.add_argument("out")
    m.add_argument("--driver", default="flagship")
    m.set_defaults(fn=cmd_mul)

    mm = sub.add_parser("mulmod", parents=[common],
                        help="multiply two binary integer files mod 2^N + 1")
    mm.add_argument("a"), mm.add_argument("b"), mm.add_argument("out")
    mm.add_argument("--nbits", type=int, required=True, help="ring width N (p = 2^N + 1)")
    mm.set_defaults(fn=cmd_mulmod)

    b = sub.add_parser("bench", parents=[common], help="time the multiply on the device")
    b.add_argument("--bits", type=int, default=10_000_000)
    b.add_argument("--reps", type=int, default=3)
    b.add_argument("--driver", default="flagship")
    b.add_argument("--batch", type=int, default=1,
                   help="k>1: k products, one mul_many call")
    b.set_defaults(fn=cmd_bench)

    s = sub.add_parser("selftest", parents=[common],
                       help="run every driver against the host oracle")
    s.add_argument("--bits", type=int, default=200_000)
    s.set_defaults(fn=cmd_selftest)

    t = sub.add_parser("tune", parents=[common],
                       help="measure candidate plans on the device, cache the kept one")
    t.add_argument("--bits", type=int, default=10_000_000)
    t.add_argument("--driver", default="flagship")
    t.add_argument("--reps", type=int, default=3)
    t.add_argument("--sweep", action="store_true",
                   help="fill the cache at 10^6..10^9 bits")
    t.set_defaults(fn=cmd_tune)

    pr = sub.add_parser(
        "profile", parents=[common],
        help="per-stage times of any driver's pipeline, or per-transform times with "
             "--transforms (ref time_mfa/time_ifft/..., mul_fft.c:5105-5286)")
    pr.add_argument("--bits", type=int, default=10_000_000)
    pr.add_argument("--reps", type=int, default=3)
    pr.add_argument("--driver", default="flagship")
    pr.add_argument("--transforms", action="store_true",
                    help="time single transforms at (--depth, --w)")
    pr.add_argument("--depth", type=int, default=12)
    pr.add_argument("--w", type=int, default=1)
    pr.add_argument("--batch", type=int, default=1)
    pr.set_defaults(fn=cmd_profile)

    g = sub.add_parser("baseline", parents=[common], help="time GMP mpn_mul (CPU baseline)")
    g.add_argument("--bits", type=int, default=10_000_000)
    g.add_argument("--reps", type=int, default=3)
    g.set_defaults(fn=cmd_baseline)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
