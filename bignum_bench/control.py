"""The control's readings, the upper end of each limit the judge holds.

    python3 bignum_bench/control.py --workload <cell> --seeds S [S ...] --seconds S

For each seed, one short window of the cell at its own size and load with
the control in the program's place: the plain reference computed a
precision lower (float32 for its float64), which must come out not
correct.  Each run prints one JSON line with the numbers compared beside
their limits.  The benchmark's own runs never run this; it needs a CUDA
card."""

import argparse
import json
import pathlib
import sys
import time

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    from bignum_bench import run as bench_run

    bench_run._environment()
    import torch

    from bignum_bench import harness, judge, spec, systems

    if not torch.cuda.is_available():
        print("the readings need a CUDA card", file=sys.stderr)
        return 2
    bench = spec.load(CHECKOUT / "BENCHMARK.json")
    for seed in args.seeds:
        t = time.perf_counter()
        run = harness.run_cell(bench, args.workload, seed, args.seconds, False,
                               make_system=lambda c, d: systems.build(c, "control", d),
                               log=lambda s: None)
        print(json.dumps({"side": "control", "seed": seed, "calls": run.window.calls,
                          "correct": judge.correct(run.numbers),
                          "checks": judge.checks(run.numbers), "info": run.numbers["info"],
                          "seconds": time.perf_counter() - t}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
