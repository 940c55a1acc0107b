"""One run of one cell: set-up, the measured window, the judge, the
metrics.  run.py calls it on the card; the tests call it on the CPU at
small sizes, with the system swapped for a broken one where they need."""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from bignum_bench import generator, judge, peaks, spans, spec, systems, window

FORBIDDEN = ("jax", "jaxlib", "flax", "mpir_fft_tpu")


def forbidden_modules(modules) -> list[str]:
    """Modules whose top-level name, compared whole, is JAX's or the JAX package's."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


# the end-to-end metrics, each from the window
END_TO_END = {
    "product_ms": lambda r: r.window.seconds / r.window.calls * 1e3,
    "peak_mem_gib": lambda r: r.peak_bytes / 2**30,
    "setup_s": lambda r: r.setup_s,
}


def program_counters(port: bool) -> dict:
    """The program's work counters (mpir_fft_tpu_torch.kernels.COUNTERS) as
    they stand; {} where the system is not the port."""
    if not port:
        return {}
    from mpir_fft_tpu_torch import kernels

    return dict(kernels.COUNTERS)


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader sees (metrics/*.py read(ctx)).
    `spans` is spans.summarize of the traced window (the program's "mf.*"
    spans by name), `counters` the change of the program's counters over
    it; None where the run gives neither."""
    summary: window.Summary
    layers: dict
    products: int
    route: dict
    hbm_bytes_per_s: float = peaks.HBM_BYTES_PER_S
    spans: dict | None = None
    counters: dict | None = None

    def layer_s_per_product(self, stem: str) -> float:
        return self.summary.layer_ns.get(stem, 0) / 1e9 / self.products


@dataclasses.dataclass
class Run:
    window: generator.Window
    setup_s: float
    peak_bytes: int
    numbers: dict
    summary: window.Summary | None = None
    context: Context | None = None


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float | None = None, config: dict | None = None,
             make_system=None, log=print) -> Run:
    """Set up the cell, measure its window, judge it.  `config` replaces the
    cell's configuration (the tests' small sizes); `make_system(config,
    device)` replaces the program."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.cell(bench, cell_name)
    config = config or spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    marks = {"start": time.perf_counter() - t0}
    system = (make_system or (lambda c, d: systems.build(c, "port", d)))(config, dev)
    marks["system"] = time.perf_counter() - t0
    if on_card:
        from mpir_fft_tpu_torch import kernels       # the kernel library: built or found

        torch.cuda.init()
        marks["cuda"] = time.perf_counter() - t0
        kernels.lib()
        marks["kernels"] = time.perf_counter() - t0
    described = {"cell": cell_name, "seed": seed, **system.describe(),
                 "peaks": peaks.describe() if on_card else "cpu"}
    log("plan " + repr(described))

    inputs = generator.make_inputs(config, traffic, seed, dev)
    sync = generator.syncer(dev)
    sync()
    marks["inputs"] = time.perf_counter() - t0
    # warm-up: the cell's own shapes, through the same loop and check
    warm_out = system(*inputs[0])
    check = None
    if traffic["loop"] == "closed":
        scratch = generator.OutputCheck(len(inputs), warm_out, generator.spans(False))
        check = generator.OutputCheck(len(inputs), warm_out, generator.spans(trace),
                                      scratch.stream)
        generator.closed_loop(system, inputs, 0.0, sync, generator.stream_syncer(dev), scratch,
                              generator.spans(False), min_calls=len(inputs) + 1)
        del scratch
    else:
        system(warm_out)
    del warm_out
    sync()
    marks["warm_up"] = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        counted = program_counters(make_system is None)
        prof.__enter__()
    setup_s = time.perf_counter() - t0
    log("set-up, seconds from the start at each step's end: " + json.dumps(marks))
    try:
        win = generator.drive(system, inputs, traffic, seconds, dev, check, trace)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    run = Run(win, setup_s, peak, {})
    if prof is not None:
        now = program_counters(make_system is None)
        counted = {k: v - counted.get(k, 0) for k, v in now.items()}
        tr = window.collect(prof)
        del prof
        layers = window.load_layers(spec.ROOT)
        run.summary = window.summarize(tr, layers)
        by_span = spans.summarize(tr)
        run.context = Context(run.summary, layers, win.calls, system.route,
                              spans=by_span, counters=counted)
        log(f"trace: {run.summary.ops} device operations of the program, "
            f"{tr.excluded} of the harness's checks left out")
        log("kernels " + json.dumps(dict(sorted(run.summary.kernels.items(),
                                                key=lambda kv: -kv[1][1]))))
        log("spans, a product: [calls, host, blocked, device, idle ms] " + json.dumps(
            spans.per_product(by_span, win.calls)) + "; counters " + json.dumps(counted))
        if run.summary.unclaimed:
            log("kernels no layer file claims: " + repr(
                {k: v / 1e6 for k, v in run.summary.unclaimed.items()}))

    # the judge: after the window, with the peak read
    final = win.final
    win.final = None
    if on_card:
        torch.cuda.empty_cache()
    if traffic["loop"] == "closed":
        run.numbers = judge.judge_closed(config, inputs, check)
    else:
        run.numbers = judge.judge_chain(config, inputs[0][0], win.calls, final)
    return run


def result_line(bench: dict, cell_name: str, run: Run, trace: bool, device_kind: str,
                platform: str) -> dict:
    """The contract's last line: correct, attempted, failed, metrics,
    device, (breakdown), and the numbers compared last."""
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(bench, cell_name, kind):
        if trace:
            value = spec.reader(m["name"]).read(run.context)
        else:
            value = END_TO_END[m["name"]](run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    ok = judge.correct(run.numbers)
    out = {"correct": ok, "attempted": run.window.calls, "failed": run.numbers["failed"],
           "metrics": metrics,
           "device": {"platform": platform, "kind": device_kind, "count": 1,
                      "memory_peak_bytes": run.peak_bytes}}
    if trace:
        s = run.summary
        out["device"]["busy_s"] = s.busy_ns / 1e9
        out["device"]["window_s"] = s.window_ns / 1e9
        out["breakdown"] = {"device_ops": s.top_ops, "idle_gaps": s.idle_gaps}
    out["checks"] = judge.checks(run.numbers)
    return out
