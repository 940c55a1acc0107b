"""What the program's own spans say in a torch.profiler window.

The port marks its stages as host spans named "mf.*"
(mpir_fft_tpu_torch.kernels.span: the driver call, its stages, the NTT's
tiers and int8 GEMMs, the host API's conversions), on the clock of the
device trace and nested by containment.  They are FUNCTION-scope record
functions, which the profiler does not project onto the device timeline,
so the window's device operations (window.make_trace) hold no span.

`summarize` reduces a window.Trace to, for each span name, the span's
calls, its host time, the host time inside it spent blocked in the
runtime (synchronise calls, a full launch queue), the device time of the
program's operations launched inside it (the runtime call that launched an
operation carries its correlation id; an operation counts under the
innermost span at its launch) and the idle gaps whose midpoint lies inside
it (under the innermost span there).  OUTERMOST sums the spans that no
other span encloses: their device and idle time is what the program's
calls launched and left idle.  NONE holds the device time launched and the
idle gaps outside every span.  The per-layer readers driver_stall_ms,
driver_enqueue_ms and int8_gemm_peak_share read `ctx.spans` (this
summary) and `ctx.counters` (the change of the program's
mpir_fft_tpu_torch.kernels.COUNTERS over the traced window), and read
None where a context carries neither."""

from __future__ import annotations

import dataclasses

from bignum_bench.window import Op, Trace, idle_gaps

PREFIX = "mf."
OUTERMOST = "(outermost)"
NONE = "(none)"
# host events in which the host waits for the device: the synchronise
# calls, and the profiler's mark of a launch that waited for room in the
# full launch queue
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "Command Buffer Full")


@dataclasses.dataclass
class SpanStats:
    calls: int = 0
    host_ns: int = 0        # the spans' own durations, children included
    blocked_ns: int = 0     # of that, in BLOCKING calls
    device_ns: int = 0      # device time of operations launched inside, innermost span
    idle_ns: int = 0        # idle gaps whose midpoint lies inside, innermost span


def _is_runtime(op: Op) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync, ...): the host event that shares its correlation id
    with the device operation it launched."""
    return op.name.startswith("cu")


def _innermost(spans: list[Op], times: list[int]) -> list[int | None]:
    """For each time, the index into `spans` (sorted by start, the longer
    first) of the innermost span that covers it, or None."""
    out: list[int | None] = [None] * len(times)
    stack: list[int] = []
    i = 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(spans) and spans[i].start_ns <= t:
            while stack and spans[stack[-1]].end_ns <= spans[i].start_ns:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]].end_ns < t:
            stack.pop()
        if stack:
            out[q] = stack[-1]
    return out


def summarize(trace: Trace) -> dict[str, SpanStats]:
    lo, hi = trace.window
    spans = sorted((op for op in trace.host if op.name.startswith(PREFIX)
                    and lo <= op.start_ns < hi), key=lambda o: (o.start_ns, -o.end_ns))
    out: dict[str, SpanStats] = {OUTERMOST: SpanStats(), NONE: SpanStats()}
    parent: list[int | None] = []           # the innermost span enclosing each
    stack: list[int] = []
    for k, op in enumerate(spans):
        while stack and spans[stack[-1]].end_ns <= op.start_ns:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        stack.append(k)
        st = out.setdefault(op.name, SpanStats())
        st.calls += 1
        st.host_ns += op.end_ns - op.start_ns
        if parent[k] is None:
            out[OUTERMOST].calls += 1
            out[OUTERMOST].host_ns += op.end_ns - op.start_ns

    blocking = [op for op in trace.host if op.name in BLOCKING and lo <= op.start_ns < hi]
    for op, k in zip(blocking, _innermost(spans, [op.start_ns for op in blocking])):
        if k is not None:
            out[OUTERMOST].blocked_ns += op.end_ns - op.start_ns
        while k is not None:
            out[spans[k].name].blocked_ns += op.end_ns - op.start_ns
            k = parent[k]

    launched = {op.correlation: op.start_ns for op in trace.host
                if op.correlation >= 0 and _is_runtime(op)}
    dev = [op for op in trace.device if op.correlation in launched]
    out[NONE].device_ns += sum(op.end_ns - op.start_ns for op in trace.device
                               if op.correlation not in launched)
    for op, k in zip(dev, _innermost(spans, [launched[op.correlation] for op in dev])):
        d = op.end_ns - op.start_ns
        if k is None:
            out[NONE].device_ns += d
        else:
            out[spans[k].name].device_ns += d
            out[OUTERMOST].device_ns += d

    gaps = idle_gaps(trace)
    for (a, b), k in zip(gaps, _innermost(spans, [(a + b) // 2 for a, b in gaps])):
        if k is None:
            out[NONE].idle_ns += b - a
        else:
            out[spans[k].name].idle_ns += b - a
            out[OUTERMOST].idle_ns += b - a
    return out


def per_product(spans: dict[str, SpanStats], products: int) -> dict[str, list]:
    """The log line's form: name -> [calls, host, blocked, device, idle ms]
    per product."""
    return {k: [s.calls / products] + [v / 1e6 / products for v in
                                        (s.host_ns, s.blocked_ns, s.device_ns, s.idle_ns)]
            for k, s in spans.items()}
