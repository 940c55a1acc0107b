"""The three readers of the truncated route (metrics/trunc_rebuild_ms.py,
mfa_trunc_ms.py, trunc_copy_gb.py) on hand-built contexts: the number
from the program's spans and counters, and None where a context carries
neither, as a parent whose program has none gives, or where the span ran
nothing."""

import pytest

from bignum_bench import spans, spec, systems, window
from bignum_bench.harness import Context
from bignum_bench.window import PRODUCT_SPAN, WINDOW_SPAN, Op

LAYERS = window.load_layers(spec.ROOT)
US = 1000
ROUTE = systems.mul_route(10**9, 10**8, 131072, 67840, 2048)
READERS = ("trunc_rebuild_ms", "mfa_trunc_ms", "trunc_copy_gb")


def _trace() -> window.Trace:
    """Two products in a 1000 us window, each mf.flagship holding mf.inv
    holding mf.mfa.trunc (a column launch, 30 us on the device in the
    first, 50 in the second) and then mf.trunc.rebuild (a twiddle launch
    of 10 us, a copy of 4 us); a ladder launched in mf.inv outside both
    (20 us), which neither span reads."""
    host = [Op(WINDOW_SPAN, 0, 1000 * US)]
    dev = []
    for i, (t0, col) in enumerate(((100, 30), (500, 50))):
        c = 10 * i
        host += [Op(PRODUCT_SPAN, (t0 - 10) * US, (t0 + 350) * US),
                 Op("mf.flagship", t0 * US, (t0 + 300) * US),
                 Op("mf.inv", (t0 + 10) * US, (t0 + 290) * US),
                 Op("mf.mfa.trunc", (t0 + 20) * US, (t0 + 60) * US),
                 Op("mf.trunc.rebuild", (t0 + 70) * US, (t0 + 90) * US),
                 Op("cudaLaunchKernel", (t0 + 30) * US, (t0 + 31) * US, c + 1),
                 Op("cudaLaunchKernel", (t0 + 72) * US, (t0 + 73) * US, c + 2),
                 Op("cudaLaunchKernel", (t0 + 80) * US, (t0 + 81) * US, c + 3),
                 Op("cudaLaunchKernel", (t0 + 100) * US, (t0 + 101) * US, c + 4)]
        dev += [Op("void ladder_kernel(int*)", (t0 + 40) * US, (t0 + 40 + col) * US, c + 1),
                Op("void twiddle_half_kernel(int*)", (t0 + 120) * US, (t0 + 130) * US, c + 2),
                Op("at::native::CatArrayBatchedCopy(int*)", (t0 + 130) * US,
                   (t0 + 134) * US, c + 3),
                Op("void ladder_kernel(int*)", (t0 + 140) * US, (t0 + 160) * US, c + 4)]
    return window.make_trace(dev, host)


def _ctx(with_spans: bool, counters=None) -> Context:
    tr = _trace()
    summary = window.summarize(tr, LAYERS)
    if not with_spans:
        return Context(summary, LAYERS, 2, ROUTE)
    return Context(summary, LAYERS, 2, ROUTE, spans=spans.summarize(tr),
                   counters=counters if counters is not None else {})


def test_readers_read_the_spans_and_the_counter():
    ctx = _ctx(True, {"int8_ops": 10, "trunc_copy_bytes": 7 * 10**9})
    assert spec.reader("mfa_trunc_ms").read(ctx) == pytest.approx((30 + 50) / 1e3 / 2)
    assert spec.reader("trunc_rebuild_ms").read(ctx) == pytest.approx(2 * (10 + 4) / 1e3 / 2)
    assert spec.reader("trunc_copy_gb").read(ctx) == pytest.approx(3.5)
    assert spec.reader("trunc_copy_gb").read(_ctx(True, {"trunc_copy_bytes": 0})) == 0


@pytest.mark.parametrize("metric", READERS)
def test_readers_are_silent_without_spans_or_counters(metric):
    """The parent's case: a context without spans or counters."""
    assert spec.reader(metric).read(_ctx(False)) is None


def test_copy_reader_is_silent_where_the_program_has_no_counter():
    """A program whose counters lack trunc_copy_bytes, as the parent's."""
    assert spec.reader("trunc_copy_gb").read(_ctx(True, {"int8_ops": 10})) is None
    assert spec.reader("trunc_copy_gb").read(_ctx(True, {})) is None


@pytest.mark.parametrize("metric", ["trunc_rebuild_ms", "mfa_trunc_ms"])
def test_span_readers_are_silent_where_the_span_ran_nothing(metric):
    tr = _trace()
    name = spec.reader(metric).SPAN
    host = [op for op in tr.host if op.name != name]
    bare = window.Trace(tr.window, tr.device, host)
    ctx = Context(window.summarize(bare, LAYERS), LAYERS, 2, ROUTE, spans=spans.summarize(bare),
                  counters={})
    assert spec.reader(metric).read(ctx) is None
