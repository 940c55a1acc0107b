"""driver_enqueue_ms (ms): host ms per product inside the program's
outermost spans (spans.py), less the time blocked there in synchronise
calls or on a full launch queue: what it costs the host to enqueue one
product.  None where the context carries no spans."""

from bignum_bench.spans import OUTERMOST


def read(ctx):
    spans = ctx.spans
    if not spans or spans[OUTERMOST].calls == 0:
        return None
    outer = spans[OUTERMOST]
    return (outer.host_ns - outer.blocked_ns) / 1e6 / ctx.products
