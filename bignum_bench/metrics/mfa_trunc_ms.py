"""mfa_trunc_ms (ms): device ms per product of the operations the program
launched inside its mf.mfa.trunc spans (spans.py): the truncated inner
transforms of the truncated sqrt2 pair, forward and inverse (the right
half's truncate1 MFAs on an odd-w plan past half the length;
mpir_fft_tpu_torch/ops/sqrt2.py).  None where the context carries no
spans, or the span ran nothing."""

SPAN = "mf.mfa.trunc"


def read(ctx):
    spans = ctx.spans
    if not spans or SPAN not in spans or spans[SPAN].device_ns <= 0:
        return None
    return spans[SPAN].device_ns / 1e6 / ctx.products
