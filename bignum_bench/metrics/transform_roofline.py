"""transform_roofline (%): the transforms' least bytes over the HBM peak,
over their device time per product (layers/transforms.json)."""

from bignum_bench.roofline import INT32, share


def least_bytes(route: dict) -> int:
    """A product: each operand's digits read and its t x L spectrum written
    (once for a square), the t x L products read and the t x L inverse
    rows written.  A square mod 2^N+1: the residue's digits read and the
    m x Lp spectrum written once, the m x Lp products read and the m x Lp
    inverse rows written."""
    if route["kind"] == "mul":
        rows = route["t"] * route["L"]
        inputs = [route["La"]] if route["square"] else [route["La"], route["Lb"]]
        return INT32 * (sum(d + rows for d in inputs) + 2 * rows)
    rows = route["m"] * route["Lp"]
    return INT32 * (route["LN"] + rows + 2 * rows)


def read(ctx):
    return share(ctx, "transforms", least_bytes(ctx.route))
