"""torch_ops_ms (ms): device ms per product of PyTorch's own kernels, the
driver's glue (copies, stacks, pads, casts, the split's regrouping), as
layers/torch_ops.json names them."""


def read(ctx):
    t = ctx.layer_s_per_product("torch_ops")
    return t * 1e3 if t > 0 else None
