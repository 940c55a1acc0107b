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
stages them; `mul(a, b, driver=...)` for the seven drivers; and
`mulmod_int`, the Fermat-ring product (a * b) mod 2^N+1.  Not ported yet:
the out-of-core driver, `mul_many` and sharding.

    from mpir_fft_tpu_torch.models.mul import mul
    mul(a, b)                      # exact product, on "cuda" by default
    mul(a, b, device="cpu")        # same pipeline on the plain torch path
    from mpir_fft_tpu_torch import mulmod_int
    mulmod_int(a, b, 1 << 22)      # (a * b) mod 2^(2^22)+1
"""

from mpir_fft_tpu_torch.ops.mulmod import mulmod_int

__all__ = ["mulmod_int"]
__version__ = "0.3.0"
