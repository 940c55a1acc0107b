"""The benchmark's declaration (BENCHMARK.json at the repository's root)
and the files it names, each found by name:

    configs/<config>.json    a configuration: what is multiplied, at which sizes
    traffic/<traffic>.json   a traffic mix: how the calls arrive, read by generator.py
    metrics/<metric>.py      a per-layer metric's reader: read(ctx) -> number or None
    layers/<stem>.json       a layer's kernels: {"layer": name, "kernels": [fragments]}

A cell, a configuration, a mix, a metric or a layer is added by adding its
file and its entry in BENCHMARK.json; no file that is there needs an edit."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parent          # the benchmark's folder
REPO = ROOT.parent                                      # the checkout it runs from

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load(path: pathlib.Path | None = None) -> dict:
    return json.loads((path or REPO / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, repo: pathlib.Path = REPO) -> dict:
    """The configuration's file, with its entry's name and source beside."""
    for c in bench["configs"]:
        if c["name"] == name:
            data = json.loads((repo / c["file"]).read_text())
            return {**data, "name": name, "source": c["source"]}
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: pathlib.Path = ROOT) -> dict:
    return {**json.loads((root / "traffic" / f"{name}.json").read_text()), "name": name}


def metrics_of(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer"): those that
    list it under "workloads", or list no workloads at all."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str, root: pathlib.Path = ROOT):
    """The module metrics/<metric>.py (its read(ctx) gives the number)."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bignum_bench_metric_" + re.sub(r"\W", "_", metric), path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader {path} for the metric {metric!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise TypeError(f"{path} has no read(ctx)")
    return mod


def names_ok(bench: dict) -> list[str]:
    """Every name, config, traffic, reduced key and unit that breaks the
    character rules (empty where all hold)."""
    bad = []
    names = [c["name"] for c in bench["configs"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    names += [w[k] for w in bench["workloads"] for k in ("name", "config", "traffic")]
    names += [m["name"] for k in ("end_to_end", "per_layer") for m in bench[k]]
    bad += [n for n in names if not NAME_RE.fullmatch(n)]
    bad += [m["unit"] for k in ("end_to_end", "per_layer") for m in bench[k]
            if not UNIT_RE.fullmatch(m["unit"])]
    return bad
