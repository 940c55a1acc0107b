"""trunc_copy_gb (GB): 10^9 bytes per product written by the torch copies
of the truncated route, the program's COUNTERS["trunc_copy_bytes"] over
the traced window (the concatenations, pads and the staged pointwise's
write-back that the truncated transforms make; mpir_fft_tpu_torch/kernels).
None where the context carries no counters, or the program counts no
such bytes (a program without the counter)."""

COUNTER = "trunc_copy_bytes"


def read(ctx):
    counters = ctx.counters
    if not counters or COUNTER not in counters:
        return None
    return counters[COUNTER] / ctx.products / 1e9
