"""The benchmark of mpir_fft_tpu_torch on one NVIDIA H100 (see run.py).

Nothing here imports jax, jaxlib, flax or the JAX package mpir_fft_tpu;
the plain reference (reference.py) imports nothing of mpir_fft_tpu_torch
either."""
