"""What a torch.profiler window over the measured window says: the device
operations of the program, their busy time as a union of intervals, their
time by layer, the idle gaps beside what the host was doing, and the
breakdown a result line carries.

The reduction works on plain records (`Op`), so that it can be checked
without a card; `collect` turns a profiler's raw events into them.  The
harness marks its own spans with names that start with "bench.": the
window ("bench.window"), each product ("bench.product") and its own
checking of an output ("bench.check"), whose device work is the
benchmark's and not the program's, and is left out of every number."""

from __future__ import annotations

import bisect
import dataclasses
import json
import pathlib

WINDOW_SPAN = "bench.window"
PRODUCT_SPAN = "bench.product"
CHECK_SPAN = "bench.check"

# gaps shorter than this are counted in the idle share but not labelled
LABEL_MIN_NS = 2_000


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    start_ns: int
    end_ns: int
    correlation: int = -1


@dataclasses.dataclass
class Trace:
    window: tuple[int, int]          # the window span on the profiler's clock
    device: list[Op]                 # the program's device operations in the window
    host: list[Op]                   # host operations (torch ops, runtime calls, spans)
    excluded: int = 0                # device operations of the harness's own checks


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without "void", anonymous namespaces and its
    argument list, at most width letters."""
    cut = name.replace("(anonymous namespace)::", "").strip()
    if cut.startswith("void "):
        cut = cut[5:]
    return (cut.split("(", 1)[0].strip() or cut)[:width]


def _ns(ev, what: str) -> int:
    if hasattr(ev, what + "_ns"):
        return int(getattr(ev, what + "_ns")())
    return int(getattr(ev, what + "_us")() * 1000)


def collect(prof) -> Trace:
    """The Trace of a finished torch.profiler.profile whose measured
    window ran inside record_function(WINDOW_SPAN)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev_raw, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        op = Op(ev.name(), start, start + _ns(ev, "duration"), int(ev.correlation_id()))
        if ev.device_type() == cuda:
            dev_raw.append(op)
        else:
            host.append(op)
    return make_trace(dev_raw, host)


def make_trace(dev_raw: list[Op], host: list[Op]) -> Trace:
    """Keep the device operations inside the window that the program ran:
    not the projections of the harness's spans onto the device, not the
    work launched inside its CHECK_SPAN spans."""
    windows = [op for op in host if op.name == WINDOW_SPAN]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} '{WINDOW_SPAN}' spans, not one")
    lo, hi = windows[0].start_ns, windows[0].end_ns
    checks = sorted((op.start_ns, op.end_ns) for op in host if op.name == CHECK_SPAN)
    starts = [s for s, _ in checks]

    def in_check(t: int) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and checks[i][1] >= t

    harness = {op.correlation for op in host
               if op.correlation >= 0 and not op.name.startswith("bench.")
               and in_check(op.start_ns)}
    device, excluded = [], 0
    for op in dev_raw:
        if op.name.startswith("bench.") or op.end_ns <= lo or op.start_ns >= hi:
            continue
        if op.correlation in harness:
            excluded += 1
            continue
        device.append(Op(op.name, max(op.start_ns, lo), min(op.end_ns, hi), op.correlation))
    return Trace((lo, hi), sorted(device, key=lambda o: o.start_ns), host, excluded)


def busy_intervals(ops: list[Op]) -> list[tuple[int, int]]:
    """The union of the operations' intervals, as sorted disjoint intervals."""
    out: list[list[int]] = []
    for op in sorted(ops, key=lambda o: o.start_ns):
        if out and op.start_ns <= out[-1][1]:
            out[-1][1] = max(out[-1][1], op.end_ns)
        else:
            out.append([op.start_ns, op.end_ns])
    return [(a, b) for a, b in out]


def busy_ns(ops: list[Op]) -> int:
    return sum(b - a for a, b in busy_intervals(ops))


def idle_gaps(trace: Trace) -> list[tuple[int, int]]:
    """The window's stretches in which no operation of the program ran."""
    lo, hi = trace.window
    gaps, t = [], lo
    for a, b in busy_intervals(trace.device):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def host_label(host_sorted: list[Op], starts: list[int], t: int) -> str:
    """The innermost host operation running at time t: of those that cover
    t, the one that started last."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        op = host_sorted[j]
        if op.end_ns >= t and op.name != WINDOW_SPAN:
            return op.name
    return "python (no traced host op)"


def gaps_by_host(trace: Trace, top: int = 10) -> list[list]:
    """Idle seconds of the window by what the host was doing in the middle
    of each gap, the largest first (gaps under LABEL_MIN_NS together)."""
    host_sorted = sorted(trace.host, key=lambda o: o.start_ns)
    starts = [op.start_ns for op in host_sorted]
    by: dict[str, int] = {}
    for a, b in idle_gaps(trace):
        label = (f"gaps under {LABEL_MIN_NS // 1000} us" if b - a < LABEL_MIN_NS else
                 "host: " + short_name(host_label(host_sorted, starts, (a + b) // 2), 80))
        by[label] = by.get(label, 0) + (b - a)
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


# ---------------------------------------------------------------------------
# Layers: each file layers/<stem>.json maps kernel name fragments to a layer
# ---------------------------------------------------------------------------

def load_layers(root: pathlib.Path) -> dict[str, dict]:
    """{file stem: {"layer": name, "kernels": [fragments]}} of root/layers."""
    out = {}
    for path in sorted((root / "layers").glob("*.json")):
        spec = json.loads(path.read_text())
        if not spec.get("layer") or not spec.get("kernels"):
            raise ValueError(f"{path}: needs 'layer' and 'kernels'")
        out[path.stem] = spec
    return out


def layer_of(name: str, layers: dict[str, dict]) -> str | None:
    """The stem of the layer file whose longest fragment the kernel's name
    holds (of fragments of one length, the first file in name order);
    None where no file claims it."""
    best, best_len = None, 0
    for stem in sorted(layers):
        for frag in layers[stem]["kernels"]:
            if frag in name and len(frag) > best_len:
                best, best_len = stem, len(frag)
    return best


@dataclasses.dataclass
class Summary:
    window_ns: int
    busy_ns: int
    ops: int
    layer_ns: dict[str, int]         # by layer file stem
    unclaimed: dict[str, int]        # device ms of kernels no layer file claims, by short name
    top_ops: list[list]              # [[short name, seconds], ...] the costliest first
    idle_gaps: list[list]            # [[host label, seconds], ...]
    kernels: dict[str, list]         # short name -> [launches, ns, layer file stem or None]


def summarize(trace: Trace, layers: dict[str, dict], top: int = 10) -> Summary:
    layer_ns: dict[str, int] = {stem: 0 for stem in layers}
    unclaimed: dict[str, int] = {}
    by_name: dict[str, int] = {}
    seen: dict[str, tuple[str | None, str]] = {}
    kernels: dict[str, list] = {}
    for op in trace.device:
        d = op.end_ns - op.start_ns
        if op.name not in seen:
            seen[op.name] = (layer_of(op.name, layers), short_name(op.name))
        stem, name = seen[op.name]
        k = kernels.setdefault(name, [0, 0, stem])
        k[0] += 1
        k[1] += d
        if stem is None:
            unclaimed[name] = unclaimed.get(name, 0) + d
        else:
            layer_ns[stem] += d
        by_name[name] = by_name.get(name, 0) + d
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    # a kernel that no layer file claims always shows in the breakdown
    listed = {k for k, _ in ranked[:top]}
    unlisted = [[k, v / 1e9] for k, v in sorted(unclaimed.items(), key=lambda kv: -kv[1])
                if k not in listed]
    keep = top - min(len(unlisted), top // 2)
    top_ops = [[k, v / 1e9] for k, v in ranked[:keep]] + unlisted[:top - keep]
    lo, hi = trace.window
    return Summary(hi - lo, busy_ns(trace.device), len(trace.device), layer_ns, unclaimed,
                   top_ops, gaps_by_host(trace, top), kernels)
