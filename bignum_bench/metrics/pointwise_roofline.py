"""pointwise_roofline (%): the pointwise products' least bytes over the
HBM peak, over their device time per product (layers/pointwise.json).
Counted in bytes only: no count of operations holds across the dense,
pair, 4-step, fused and schoolbook tiers, so the share reads low by design."""

from bignum_bench.roofline import INT32, share


def least_bytes(route: dict) -> int:
    """The spectra read (one for a square) and the products written, each
    t x L (a product) or m x Lp (a square mod 2^N+1) int32 digits."""
    rows = route["t"] * route["L"] if route["kind"] == "mul" else route["m"] * route["Lp"]
    return INT32 * rows * (2 if route["square"] else 3)


def read(ctx):
    return share(ctx, "pointwise", least_bytes(ctx.route))
