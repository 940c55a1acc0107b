"""trunc_rebuild_ms (ms): device ms per product of the operations the
program launched inside its mf.trunc.rebuild spans (spans.py): the
truncated inverse's rebuild past trunc, the right half's missing inputs
(one twiddle_half pass and their concatenation) and the left half's
doubled rows with their norm tail (mpir_fft_tpu_torch/ops/sqrt2.py).
None where the context carries no spans, or the span ran nothing."""

SPAN = "mf.trunc.rebuild"


def read(ctx):
    spans = ctx.spans
    if not spans or SPAN not in spans or spans[SPAN].device_ns <= 0:
        return None
    return spans[SPAN].device_ns / 1e6 / ctx.products
