"""A layer's share of its roofline: the least time its work could take on
the card, its least bytes over the HBM peak (peaks.py), over the device
time its kernels took per product in the traced window.

Least bytes are worked out from the plan alone (systems.mul_route /
sqrmod_route), by each metric's own function beside it: each input of the
layer read once and each output written once, as int32 digits, at the
boundaries that every implementation of the route keeps (the operands'
digits, the t x L spectrum and product rows, the product's or the residue's
digits).  So the count reads the same work whatever implements the layer,
and a fusion that moves work between layers cannot push a share past 100%."""

from __future__ import annotations

INT32 = 4


def share(ctx, stem: str, least_bytes: int) -> float | None:
    """100 x least time / the layer's device time per product, or None
    where the layer ran nothing in the window."""
    t = ctx.layer_s_per_product(stem)
    if t <= 0:
        return None
    return 100.0 * least_bytes / ctx.hbm_bytes_per_s / t
