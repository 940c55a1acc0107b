"""The benchmark of mpir_fft_tpu_torch: one run of one cell.

    python3 bignum_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, its traffic
mix and its metrics are those BENCHMARK.json names.  The run sets up the
cell (the kernel library built or found, the inputs made on the card from
the seed, the cell's shapes warmed up), measures one window of --seconds,
judges every output of the window against the plain reference, and prints
as its last line one JSON object: correct, attempted, failed, metrics (the
cell's end-to-end metrics, or with --trace 1 its per-layer metrics read
from a torch.profiler window over the measured window), device and, with
--trace 1, breakdown; the numbers compared come last, under "checks", and
again as the last lines on standard error.  It needs a CUDA card, and
exits with 2 and no result without one."""

import time

T0 = time.perf_counter()        # set-up is timed from here: the process's first statement

import argparse     # noqa: E402
import json         # noqa: E402
import os           # noqa: E402
import pathlib      # noqa: E402
import sys          # noqa: E402

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def _environment() -> None:
    """The port at its defaults, and every cache of a build in the checkout
    at a fixed path, so that only a cell's first run there builds."""
    for key in [k for k in os.environ if k.startswith("MPIR_FFT_")]:
        del os.environ[key]
    cache = CHECKOUT / ".cache" / "bignum_bench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from bignum_bench import harness, spec

    t_import = time.perf_counter() - T0
    bench = spec.load(CHECKOUT / "BENCHMARK.json")
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"set-up: torch and the harness imported at {t_import:.2f} s, the card seen at "
          f"{time.perf_counter() - T0:.2f} s", flush=True)
    run = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t0=T0, log=lambda s: print(s, flush=True))
    found = harness.forbidden_modules(sys.modules)
    if found:
        print("the run loaded JAX or the JAX package: " + ", ".join(found), file=sys.stderr)
        return 3
    print("judge " + json.dumps(run.numbers["info"]), flush=True)
    line = harness.result_line(bench, args.workload, run, bool(args.trace),
                               torch.cuda.get_device_name(0), "gpu")
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
