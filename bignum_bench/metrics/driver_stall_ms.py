"""driver_stall_ms (ms): idle device ms per product in gaps whose midpoint
lies inside one of the program's own spans (spans.py): the card waiting on
the program's host code, not on the harness's loop or its synchronise.
None where the context carries no spans."""

from bignum_bench.spans import OUTERMOST


def read(ctx):
    spans = ctx.spans
    if not spans or spans[OUTERMOST].calls == 0:
        return None
    return spans[OUTERMOST].idle_ns / 1e6 / ctx.products
