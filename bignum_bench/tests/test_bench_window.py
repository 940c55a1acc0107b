"""The trace reduction on plain records, and the rooflines' least bytes at
the cells' plans (the counts PERF.md gives)."""

import pytest

from bignum_bench import spec, systems, window
from bignum_bench.harness import Context
from bignum_bench.window import CHECK_SPAN, WINDOW_SPAN, Op

LAYERS = window.load_layers(spec.ROOT)


US = 1000          # the records are in ns; the gaps here are labelled (>= 2 us)


def trace():
    host = [Op(WINDOW_SPAN, 0, 1000 * US), Op(CHECK_SPAN, 600 * US, 650 * US),
            Op("cudaLaunchKernel", 610 * US, 620 * US, correlation=77),
            Op("cudaLaunchKernel", 100 * US, 110 * US, correlation=5),
            Op("aten::cat", 300 * US, 400 * US)]
    dev = [Op("void ladder_kernel(int*)", 100 * US, 200 * US, 5),
           Op("void ladder_kernel(int*)", 150 * US, 250 * US),
           Op("cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8>(P)", 500 * US, 700 * US),
           Op("void at::native::ne_kernel(bool*)", 650 * US, 690 * US, 77),   # the harness's
           Op(WINDOW_SPAN, 0, 1000 * US),                          # a span's projection
           Op("Memcpy DtoD (Device -> Device)", 950 * US, 1100 * US)]  # clipped at the window
    return window.make_trace(dev, host)


def test_busy_is_a_union_and_the_harness_is_left_out():
    tr = trace()
    assert tr.excluded == 1 and len(tr.device) == 4
    s = window.summarize(tr, LAYERS)
    assert s.window_ns == 1000 * US and s.busy_ns == (150 + 200 + 50) * US
    assert s.layer_ns["transforms"] == 200 * US and s.layer_ns["pointwise"] == 200 * US
    assert s.layer_ns["torch_ops"] == 50 * US and s.unclaimed == {}
    assert [k for k, _ in s.top_ops][:2] == ["ladder_kernel", "cutlass::Kernel2<cutlass_80_"
                                             "tensorop_i16832gemm_s8>"]
    gaps = dict(s.idle_gaps)
    assert gaps["host: aten::cat"] == pytest.approx(250e-6)
    assert sum(gaps.values()) == pytest.approx(600e-6)


def test_an_unclaimed_kernel_is_listed():
    tr = window.Trace((0, 100), [Op("void brand_new_kernel(int*)", 0, 10)] +
                      [Op(f"void at::native::k{i}(int)", 10, 20 + i) for i in range(12)], [])
    s = window.summarize(tr, LAYERS)
    assert "brand_new_kernel" in s.unclaimed and len(s.top_ops) <= 10
    assert "brand_new_kernel" in [k for k, _ in s.top_ops]


def test_no_program_kernel_name_is_claimed_twice_at_one_length():
    frags = [(stem, f) for stem, spec_ in LAYERS.items() for f in spec_["kernels"]]
    for stem, f in frags:
        rivals = [s for s, g in frags if s != stem and len(g) == len(f) and (g in f or f in g)]
        assert not rivals, (stem, f, rivals)


MUL6 = systems.mul_route(100577280, 100577280, 32768, 32768, 1024)
F30 = systems.sqrmod_route(1 << 30, 65536, 4096)


@pytest.mark.parametrize("metric,route,want", [
    ("transform_roofline", MUL6, 587_159_552),
    ("pointwise_roofline", MUL6, 402_653_184),
    ("norm_combine_roofline", MUL6, 100_577_280),
    ("transform_roofline", F30, 3_489_660_928),
    ("pointwise_roofline", F30, 2_147_483_648),
    ("norm_combine_roofline", F30, 536_870_912),
])
def test_least_bytes_at_the_cells_plans(metric, route, want):
    assert spec.reader(metric).least_bytes(route) == want


def test_shares_and_silence():
    tr = window.Trace((0, 10**9), [Op("void ladder_kernel(int*)", 0, 2 * 10**6)], [])
    s = window.summarize(tr, LAYERS)
    ctx = Context(s, LAYERS, 1, MUL6)
    want = 100 * 587_159_552 / 3.35e12 / 2e-3
    assert spec.reader("transform_roofline").read(ctx) == pytest.approx(want)
    assert spec.reader("pointwise_roofline").read(ctx) is None       # nothing to read
    assert spec.reader("device_idle_share").read(ctx) == pytest.approx(99.8)
    assert spec.reader("kernels_per_product").read(ctx) == 1
