"""int8_gemm_peak_share (%): the NTT's int8 GEMMs' share of the card's
dense int8 peak (peaks.py): the int8 operations the program counted over
the traced window (its COUNTERS["int8_ops"], two a multiply-add, padded
rows included) per product, over the device time per product of the
operations launched inside its mf.int8_gemm spans (spans.py).  None where
the context carries no spans or counters, or the window ran no GEMM."""

from bignum_bench.peaks import INT8_OPS_PER_S


def read(ctx):
    spans, counters = ctx.spans, ctx.counters
    if not spans or not counters or "mf.int8_gemm" not in spans:
        return None
    ops, ns = counters.get("int8_ops", 0), spans["mf.int8_gemm"].device_ns
    if ops <= 0 or ns <= 0:
        return None
    return 100.0 * (ops / ctx.products) / (ns / 1e9 / ctx.products) / INT8_OPS_PER_S
