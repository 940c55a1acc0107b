"""BENCHMARK.json against the contract's character rules, and the benchmark
found by name: each cell's configuration, traffic mix, metric readers and
layer files, and a cell, mix, metric and layer added as new files only."""

import json
import pathlib
import shutil

import pytest

from bignum_bench import generator, harness, spans, spec, systems, window
from bignum_bench.harness import Context

REPO = spec.REPO
BENCH = spec.load()


def test_names_and_units_use_only_allowed_characters():
    assert spec.names_ok(BENCH) == []
    for bad in ("a b", "a,b", "a/b", "", "x" * 65, "µs"):
        assert not spec.NAME_RE.fullmatch(bad)
    assert not spec.UNIT_RE.fullmatch("tokens per second")
    assert spec.UNIT_RE.fullmatch("kernels/product")


def test_declaration_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert m["name"] in harness.END_TO_END          # the harness takes it from the window
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert (spec.ROOT / "metrics" / f"{m['name']}.py").is_file()
        assert callable(spec.reader(m["name"]).read)
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    assert len(set(names)) == len(names)
    for c in BENCH["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"} and c["chips"] == 1
        assert len(c["why"]) <= 200
    assert all((REPO / p).is_dir() for p in BENCH["paths"])
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves_its_files_by_name(cell):
    c = spec.cell(BENCH, cell)
    config = spec.config(BENCH, c["config"])
    assert (config["operation"], "port") in systems.SYSTEMS
    assert (config["operation"], "control") in systems.SYSTEMS
    assert spec.traffic(c["traffic"])["loop"] in generator.LOOPS
    e2e = {m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = spec.metrics_of(BENCH, cell, "per_layer")
    assert per_layer
    layer_names = {s["layer"] for s in window.load_layers(spec.ROOT).values()}
    for m in per_layer:
        assert callable(spec.reader(m["name"]).read)
        assert m["layer"] in layer_names | {"device", "driver"}


def test_config_files_are_under_paths_and_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert any(f.startswith(p + "/") for p in BENCH["paths"])
        assert (REPO / f).is_file()


KNOWN = {
    "void (anonymous namespace)::ladder_kernel(int const*, int*, long long)": "transforms",
    "void (anonymous namespace)::mfa_cols_kernel(int const*)": "transforms",
    "(anonymous namespace)::input_planes_kernel(int const*, signed char*, long long, int)":
        "pointwise",
    "(anonymous namespace)::ntt4_input_planes_kernel(int const*, signed char*, long long)":
        "pointwise",
    "void (anonymous namespace)::garner_post_kernel(int const*)": "pointwise",
    "cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_align16>(Params)":
        "pointwise",
    "(anonymous namespace)::normmod_fold_kernel(int*, int const*)": "norm_combine",
    "(anonymous namespace)::canon_reset_kernel(int*, long long)": "norm_combine",
    "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int>>()":
        "torch_ops",
    "Memcpy DtoD (Device -> Device)": "torch_ops",
}


def test_layer_files_claim_the_program_kernels():
    layers = window.load_layers(spec.ROOT)
    for name, stem in KNOWN.items():
        assert window.layer_of(name, layers) == stem, name
    assert window.layer_of("some_new_kernel(int*)", layers) is None


def _files(root: pathlib.Path) -> dict:
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts and "tests" not in p.relative_to(root).parts}


# a reader of the program's own spans and counters, as a later cell's metric
SPAN_READER = """
def read(ctx):
    if not ctx.spans or ctx.counters is None or "mf.mulmod" not in ctx.spans:
        return None
    return ctx.counters.get("int8_ops", 0) / ctx.spans["mf.mulmod"].calls
"""


def test_a_new_cell_mix_metric_and_layer_are_files_only(tmp_path):
    """What a later PR adds: a product cell with its own mix, layer and
    kernel metric, and a square mod 2^N+1 cell with a metric that reads the
    program's spans and counters, each as new files and new entries only;
    every metric that lists no cells reaches the new cells unasked."""
    before = _files(spec.ROOT)
    root = tmp_path / "bignum_bench"
    shutil.copytree(spec.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "configs" / "tiny.json").write_text(json.dumps(
        {"operation": "mul", "bits_a": 4096, "bits_b": 2048}))
    (root / "configs" / "tiny_ring.json").write_text(json.dumps(
        {"operation": "sqrmod_fermat", "N": 1 << 16}))
    (root / "traffic" / "burst.json").write_text(json.dumps({"loop": "closed", "pool": 2}))
    (root / "metrics" / "new_kernel_ms.py").write_text(
        "def read(ctx):\n    t = ctx.layer_s_per_product('newlayer')\n"
        "    return t * 1e3 if t > 0 else None\n")
    (root / "metrics" / "mulmod_int8_ops.py").write_text(SPAN_READER)
    (root / "layers" / "newlayer.json").write_text(json.dumps(
        {"layer": "a new layer", "kernels": ["some_new_kernel"]}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"] += [
        {"name": "tiny", "source": "test", "file": "bignum_bench/configs/tiny.json",
         "reduced": [], "why": "test"},
        {"name": "tiny_ring", "source": "test", "file": "bignum_bench/configs/tiny_ring.json",
         "reduced": [], "why": "test"}]
    bench["workloads"] += [
        {"name": "tiny.burst", "config": "tiny", "traffic": "burst", "chips": 1, "why": "test"},
        {"name": "tiny_ring.chain", "config": "tiny_ring", "traffic": "chain", "chips": 1,
         "why": "test"}]
    bench["per_layer"] += [
        {"name": "new_kernel_ms", "unit": "ms", "better": "lower", "source": "device_trace",
         "layer": "a new layer", "moves": "product_ms", "workloads": ["tiny.burst"]},
        {"name": "mulmod_int8_ops", "unit": "ops/product", "better": "lower",
         "source": "program_counter", "layer": "pointwise", "moves": "product_ms",
         "workloads": ["tiny_ring.chain"]}]
    assert spec.names_ok(bench) == []
    listless = {k: {m["name"] for m in BENCH[k] if "workloads" not in m}
                for k in ("end_to_end", "per_layer")}
    assert {"product_ms", "peak_mem_gib", "setup_s"} <= listless["end_to_end"]
    for name, own in (("tiny.burst", "new_kernel_ms"), ("tiny_ring.chain", "mulmod_int8_ops")):
        cell = spec.cell(bench, name)
        config = spec.config(bench, cell["config"], repo=tmp_path)
        assert (config["operation"], "port") in systems.SYSTEMS
        assert spec.traffic(cell["traffic"], root=root)["loop"] in generator.LOOPS
        assert {m["name"] for m in spec.metrics_of(bench, name, "end_to_end")} == \
            listless["end_to_end"]
        assert {m["name"] for m in spec.metrics_of(bench, name, "per_layer")} == \
            listless["per_layer"] | {own}
        for m in spec.metrics_of(bench, name, "per_layer"):
            assert callable(spec.reader(m["name"], root=root).read)
    assert spec.traffic("burst", root=root)["pool"] == 2

    layers = window.load_layers(root)
    assert window.layer_of("void some_new_kernel(int*)", layers) == "newlayer"
    tr = window.Trace((0, 1000), [window.Op("void some_new_kernel(int*)", 100, 300)], [])
    ctx = Context(window.summarize(tr, layers), layers, 2,
                  systems.mul_route(4096, 2048, 64, 64, 16))
    assert spec.reader("new_kernel_ms", root=root).read(ctx) == pytest.approx(1e-4)

    span_reader = spec.reader("mulmod_int8_ops", root=root)
    host = [window.Op(window.WINDOW_SPAN, 0, 1000), window.Op("mf.mulmod", 100, 300),
            window.Op("mf.mulmod", 400, 600), window.Op("mf.fwd", 420, 500)]
    tr = window.make_trace([], host)
    ring = systems.sqrmod_route(1 << 16, 1, 4096)
    ctx = Context(window.summarize(tr, layers), layers, 2, ring,
                  spans=spans.summarize(tr), counters={"int8_ops": 3000})
    assert span_reader.read(ctx) == 1500
    assert span_reader.read(Context(window.summarize(tr, layers), layers, 2, ring)) is None

    # the copy's files that were there are unchanged, and so is the benchmark
    assert {k: v for k, v in _files(root).items() if k in before} == before
    assert _files(spec.ROOT) == before
