"""The program's spans in a trace (spans.py) on plain records, and the
three readers of them (metrics/driver_stall_ms.py, driver_enqueue_ms.py,
int8_gemm_peak_share.py), including their silence where a context carries
no spans or counters, as a parent whose program has none gives."""

import dataclasses

import pytest

from bignum_bench import spans, spec, systems, window
from bignum_bench.harness import Context
from bignum_bench.peaks import INT8_OPS_PER_S
from bignum_bench.window import CHECK_SPAN, PRODUCT_SPAN, WINDOW_SPAN, Op

LAYERS = window.load_layers(spec.ROOT)
US = 1000
GEMM = "cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_align16>(P)"
READERS = ("driver_stall_ms", "driver_enqueue_ms", "int8_gemm_peak_share")


def _trace(with_spans: bool) -> window.Trace:
    """Two products in a 1000 us window.  The first: mf.flagship (100-400)
    holding mf.pw (150-300) holding mf.int8_gemm (160-170, launch 160 ->
    GEMM 200-260) and a launch at 280 (ladder 300-320); the flagship's own
    launch at 120 (ladder 130-150); the GEMM's launch waiting for room in
    the launch queue (162-168) and a cudaStreamSynchronize inside the
    flagship (380-400), both blocked.  The second: mf.flagship (500-600), a
    launch at 510 (ladder 650-700, launched inside, run after it).  A
    Memcpy launched by the harness outside every span (launch 900, 950-980)."""
    host = [Op(WINDOW_SPAN, 0, 1000 * US), Op(PRODUCT_SPAN, 90 * US, 420 * US),
            Op(PRODUCT_SPAN, 490 * US, 720 * US),
            Op("cudaLaunchKernel", 120 * US, 122 * US, 1),
            Op("cudaLaunchKernel", 160 * US, 162 * US, 2),
            Op("cudaLaunchKernel", 280 * US, 282 * US, 3),
            Op("Command Buffer Full", 162 * US, 168 * US),
            Op("cudaStreamSynchronize", 380 * US, 400 * US, 4),
            Op("cudaLaunchKernel", 510 * US, 512 * US, 5),
            Op("cudaMemcpyAsync", 900 * US, 902 * US, 6),
            Op("aten::cat", 520 * US, 530 * US, 2)]        # a torch op: its own id space
    if with_spans:
        host += [Op("mf.flagship", 100 * US, 400 * US), Op("mf.pw", 150 * US, 300 * US),
                 Op("mf.int8_gemm", 160 * US, 170 * US), Op("mf.flagship", 500 * US, 600 * US)]
    dev = [Op("void ladder_kernel(int*)", 130 * US, 150 * US, 1), Op(GEMM, 200 * US, 260 * US, 2),
           Op("void ladder_kernel(int*)", 300 * US, 320 * US, 3),
           Op("void ladder_kernel(int*)", 650 * US, 700 * US, 5),
           Op("Memcpy DtoD (Device -> Device)", 950 * US, 980 * US, 6)]
    return window.make_trace(dev, host)


def test_host_spans_change_no_existing_number():
    """The spans are host events: the device operations, busy time, layers
    and kernels are those of the same trace without them; only the idle
    gaps' labels may name them."""
    plain, traced = (window.summarize(_trace(w), LAYERS) for w in (False, True))
    for f in dataclasses.fields(window.Summary):
        if f.name != "idle_gaps":
            assert getattr(traced, f.name) == getattr(plain, f.name), f.name
    assert sum(v for _, v in traced.idle_gaps) == pytest.approx(
        sum(v for _, v in plain.idle_gaps))
    assert "host: mf.pw" in dict(traced.idle_gaps)


def test_spans_aggregate_nest_and_attribute_by_correlation():
    s = spans.summarize(_trace(True))
    fl, pw, gemm = s["mf.flagship"], s["mf.pw"], s["mf.int8_gemm"]
    assert (fl.calls, pw.calls, gemm.calls) == (2, 1, 1)
    assert fl.host_ns == 400 * US and pw.host_ns == 150 * US and gemm.host_ns == 10 * US
    # blocked time counts in the span it falls in and in every span around it
    assert gemm.blocked_ns == 6 * US and pw.blocked_ns == 6 * US
    assert fl.blocked_ns == 26 * US
    # device time by the innermost span at each launch
    assert gemm.device_ns == 60 * US
    assert pw.device_ns == 20 * US
    assert fl.device_ns == 20 * US + 50 * US
    outer = s[spans.OUTERMOST]
    assert (outer.calls, outer.host_ns, outer.blocked_ns) == (2, 400 * US, 26 * US)
    assert outer.device_ns == 150 * US and s[spans.NONE].device_ns == 30 * US
    # gaps: 0-130, 150-200 (mid 175: pw), 260-300 (280: pw), 320-650 (485:
    # none), 700-950 (825: none), 980-1000 (none); 0-130's midpoint 65: none
    assert pw.idle_ns == 90 * US and fl.idle_ns == 0
    assert outer.idle_ns == 90 * US
    assert s[spans.NONE].idle_ns == (130 + 330 + 250 + 20) * US
    per = spans.per_product(s, 2)
    assert per["mf.flagship"] == pytest.approx([1.0, 0.2, 0.013, 0.035, 0.0])


def test_spans_outside_the_window_and_the_checks_are_left_out():
    tr = _trace(True)
    host = tr.host + [Op("mf.flagship", 2000 * US, 2100 * US), Op(CHECK_SPAN, 990 * US, 995 * US)]
    s = spans.summarize(window.Trace(tr.window, tr.device, host))
    assert s["mf.flagship"].calls == 2


def _ctx(with_spans: bool, counters=None, products: int = 2):
    """The context a traced run gives, or with_spans False the parent's
    case: a context that carries neither spans nor counters."""
    tr = _trace(with_spans)
    route = systems.mul_route(100577280, 100577280, 32768, 32768, 1024)
    if not with_spans:
        return Context(window.summarize(tr, LAYERS), LAYERS, products, route)
    return Context(window.summarize(tr, LAYERS), LAYERS, products, route,
                   spans=spans.summarize(tr), counters=counters if counters is not None else {})


def test_readers_read_the_spans_and_counters():
    ops = 2 * 10**9
    ctx = _ctx(True, {"int8_ops": ops})
    assert spec.reader("driver_stall_ms").read(ctx) == pytest.approx(0.045)
    assert spec.reader("driver_enqueue_ms").read(ctx) == pytest.approx((400 - 26) / 1e3 / 2)
    want = 100 * (ops / 2) / (60e-6 / 2) / INT8_OPS_PER_S
    got = spec.reader("int8_gemm_peak_share").read(ctx)
    assert got == pytest.approx(want) and 0 < got < 100


@pytest.mark.parametrize("metric", READERS)
def test_readers_are_silent_without_spans(metric):
    """The parent's case: a context without spans or counters."""
    assert spec.reader(metric).read(_ctx(False)) is None


def test_gemm_share_is_silent_without_the_counter():
    assert spec.reader("int8_gemm_peak_share").read(_ctx(True, {})) is None
    assert spec.reader("int8_gemm_peak_share").read(_ctx(True, {"int8_ops": 0})) is None
