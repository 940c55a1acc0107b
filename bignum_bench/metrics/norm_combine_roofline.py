"""norm_combine_roofline (%): normalisation and split / combine, least
bytes over the HBM peak, over their device time per product
(layers/norm_combine.json).  Counted at the layer's one boundary that no
fusion can take from it: the canonical result, read once in its redundant
form and written once (the product's digits, or the residue's)."""

from bignum_bench.roofline import INT32, share


def least_bytes(route: dict) -> int:
    digits = route["out_digits"] if route["kind"] == "mul" else route["LN"]
    return INT32 * 2 * digits


def read(ctx):
    return share(ctx, "norm_combine", least_bytes(ctx.route))
