"""PyTorch + CUDA port of mpir_fft_tpu: exact big-integer multiplication by
the truncated sqrt2 Schoenhage-Strassen pipeline over Z/(2^W+1)Z, on
redundant signed base-2^16 digits in int32.

The layout mirrors the JAX package (`ops/`, `models/`, `utils/`): each
module has one counterpart under the same name there, which is the
reference the port is tested against.  Plain functions on int32 tensors
with an explicit device; the hand-written Hopper kernels live in `csrc/`,
are built by `kernels/` at first use, and are launched by the wrappers in
`ops/fused.py` and `ops/pointwise_fused.py`.

What the port serves today: `models.mul.mul` / `sqr` for plans with even
`w` whose pointwise ring the schoolbook base serves (2L <= 4096), through
full-length transforms.  Odd `w`, the NTT-CRT leaf, the recursive Fermat
mulmod, truncation, the MFA and the staged/out-of-core drivers raise
NotImplementedError.

    from mpir_fft_tpu_torch.models.mul import mul
    mul(a, b)                      # exact product, on "cuda" by default
    mul(a, b, device="cpu")        # same pipeline on the plain torch path
"""

__version__ = "0.1.0"
