"""Whole runs of the cells on the CPU at small sizes, the harness's look for
a card skipped: the seeded inputs, the judge passing the program and
failing the control and each fault a cell can have, and the last line."""

import json
import subprocess
import sys

import pytest
import torch

from bignum_bench import generator, harness, judge, spans, spec, systems

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
# each cell's size on the CPU, by its configuration's operation
SMALL = {"mul": {"bits_a": 40000, "bits_b": 40000}, "sqrmod_fermat": {"N": 1 << 16}}


def small(cell: str) -> dict:
    config = spec.config(BENCH, spec.cell(BENCH, cell)["config"])
    return {**config, **SMALL[config["operation"]]}


def loop(cell: str) -> str:
    return spec.traffic(spec.cell(BENCH, cell)["traffic"])["loop"]


def run(cell, make_system=None, seed=2**31 + 11, seconds=0.3, trace=False):
    return harness.run_cell(BENCH, cell, seed, seconds, trace, device="cpu",
                            config=small(cell), make_system=make_system, log=lambda s: None)


@pytest.mark.parametrize("cell", CELLS)
def test_seeded_inputs_reproduce(cell):
    config, traffic = small(cell), spec.traffic(spec.cell(BENCH, cell)["traffic"])
    one = generator.make_inputs(config, traffic, 2**31 + 5, "cpu")
    two = generator.make_inputs(config, traffic, 2**31 + 5, "cpu")
    other = generator.make_inputs(config, traffic, 2**31 + 6, "cpu")
    for x, y, z in zip(one, two, other):
        for a, b, c in zip(x, y, z):
            assert torch.equal(a, b) and not torch.equal(a, c)
            assert int(a.min()) >= 0 and int(a.max()) < 1 << 16
            assert int(a[-1]) >> 15 == 1            # full width: the top bit set
    if traffic["loop"] == "closed":
        assert len(one) == traffic["pool"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes_and_every_output_is_judged(cell):
    r = run(cell)
    assert judge.correct(r.numbers), r.numbers
    assert r.numbers["info"]["judged_by_reference"] >= 1
    line = harness.result_line(BENCH, cell, r, False, "cpu", "cpu")
    assert list(line)[-1] == "checks" and line["correct"] and line["failed"] == 0
    assert line["attempted"] == r.window.calls
    assert set(line["metrics"]) == {m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")}
    json.dumps(line)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    r = run(cell, lambda c, d: systems.build(c, "control", d))
    assert not judge.correct(r.numbers)
    assert r.numbers["wrong_outputs"] > 0 and r.numbers["wrong_digits"] > 0


class Altered:
    """The program with one digit of its k-th answer changed where it is made."""

    def __init__(self, system, k: int):
        self.system, self.k, self.calls = system, k, 0
        self.route, self.describe = system.route, system.describe

    def __call__(self, *args):
        out = self.system(*args)
        self.calls += 1
        if self.calls == self.k:
            out = out.clone()
            out[len(out) // 3] ^= 1
        return out


class Unchanged:
    """The program whose k-th step returns its state unchanged."""

    def __init__(self, system, k: int):
        self.system, self.k, self.calls = system, k, 0
        self.route, self.describe = system.route, system.describe

    def __call__(self, *args):
        self.calls += 1
        return args[0] if self.calls == self.k else self.system(*args)


def broken(fault, k):
    return lambda c, d: fault(systems.build(c, "port", d), k)


# set-up makes the first calls (a closed loop: one, then pool + 1 more, six
# in all; a chain: two): k past them lands in the window, on a kept output
# or on a later one
FAULTS = {
    "closed": [(Altered, 8),        # the first output of a pool entry: kept, judged
               (Altered, 14)],      # a later output: compared with the kept one
    "chain": [(Altered, 4), (Unchanged, 4)],
}


@pytest.mark.parametrize("cell,fault,k", [(c, f, k) for c in CELLS for f, k in FAULTS[loop(c)]])
def test_each_fault_fails(cell, fault, k):
    r = run(cell, broken(fault, k), seconds=1.0)
    assert r.window.calls >= 8
    assert not judge.correct(r.numbers), (fault.__name__, k, r.numbers)
    assert r.numbers["failed"] >= 1


def test_a_traced_run_carries_the_programs_spans_and_counters():
    """The context a traced run hands the readers: the port's spans over the
    window, its counters' change, and a span metric reading a number."""
    cell = next(c for c in CELLS if spec.config(
        BENCH, spec.cell(BENCH, c)["config"])["operation"] == "mul")
    r = run(cell, trace=True)
    assert judge.correct(r.numbers), r.numbers
    ctx = r.context
    assert ctx.spans[spans.OUTERMOST].calls > 0
    assert isinstance(ctx.counters, dict)
    assert isinstance(spec.reader("driver_enqueue_ms").read(ctx), float)
    line = harness.result_line(BENCH, cell, r, True, "cpu", "cpu")
    assert "driver_enqueue_ms" in line["metrics"]


def test_run_without_a_card_exits_with_no_result():
    res = subprocess.run([sys.executable, str(spec.ROOT / "run.py"), "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.REPO, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(cuda_card):
    res = subprocess.run([sys.executable, str(spec.ROOT / "run.py"), "--workload",
                          CELLS[0], "--seed", "2147483659", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=spec.REPO,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
