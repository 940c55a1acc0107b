"""kernels_per_product (kernels/product): the program's device operations
in the traced window (kernels, copies and fills on the device; the
harness's own checks left out) over the products (squarings) completed."""


def read(ctx):
    if ctx.summary.ops == 0:
        return None
    return ctx.summary.ops / ctx.products
