"""PyTorch + CUDA port of mpir_fft_tpu: exact big-integer multiplication by
the truncated sqrt2 Schoenhage-Strassen pipeline over Z/(2^W+1)Z, on
redundant signed base-2^16 digits in int32.

The layout mirrors the JAX package (`ops/`, `models/`, `utils/`): each
module has one counterpart under the same name there, which is the
reference the port is tested against.  Plain functions on int32 tensors
with an explicit device; the hand-written Hopper kernels live in `csrc/`,
are built by `kernels/` at first use, and are launched by the wrappers in
`ops/fused.py`, `ops/pointwise_fused.py` and `ops/ntt.py`.  The NTT's int8
GEMMs are torch._int_mm.

What the port serves today: `models.mul.mul` / `sqr` for every plan the
planner picks -- the reference's default plans, or with MPIR_FFT_NTT=0 its
A/B plans -- (odd and even `w`; the NTT-CRT pointwise for power-of-two
L <= 8192, dense up to 2048 and 4-step above, the schoolbook for other
L <= 2048, the recursive Fermat mulmod for the rest), through the
full-length flat pair or, where an unbalanced plan truncates, the
truncated MFA, staged from conv_len * L > 2^24 elements as the reference
stages them, past 2^29 elements out of core (`models/huge.py`) or, for
extreme imbalance, as balanced pieces; `mul(a, b, driver=...)` for the
seven drivers; `mul_many`, a batch of products in one driver call; and
`mulmod_int`, the Fermat-ring product (a * b) mod 2^N+1; and the tools
around them: the command line (`python -m mpir_fft_tpu_torch.cli`), the
device-keyed plan tuner (`utils/tune.py`) and the stage profile
(`utils/profile.py`); and sharding over the ranks of a torch.distributed
group (`parallel/`: the column / row-sharded MFA with one all-to-all, the
sharded staged flagship, the data-parallel batch and the sharded
out-of-core engine).

Public API (the reference's eight names, mpir_fft_tpu/__init__.py:24-33):

  mul(a, b)          exact product of two nonnegative Python ints (flagship)
  sqr(a)             exact square, ONE forward transform
  mul_many(pairs)    k products in one batched driver call
  DRIVERS            the seven drivers: name -> (function, needs sqrt2)
  mulmod(x, y, N)    product mod 2^N + 1 of ring-element digit tensors
  mulmod_int(a,b,N)  product mod 2^N + 1 of Python ints
  choose_params      the plan selector (depth / w / truncation / sqrt2)
  plan_for_depth     the plan at a given depth

    from mpir_fft_tpu_torch import mul, mulmod_int
    mul(a, b)                      # exact product, on "cuda" by default
    mul(a, b, device="cpu")        # same pipeline on the plain torch path
    mulmod_int(a, b, 1 << 22)      # (a * b) mod 2^(2^22)+1
"""

from mpir_fft_tpu_torch.models.mul import DRIVERS, mul, mul_many, sqr
from mpir_fft_tpu_torch.ops.mulmod import mulmod, mulmod_int
from mpir_fft_tpu_torch.utils.params import choose_params, plan_for_depth

__all__ = ["DRIVERS", "choose_params", "mul", "mul_many", "mulmod", "mulmod_int",
           "plan_for_depth", "sqr"]
__version__ = "0.4.0"
