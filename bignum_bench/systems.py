"""The systems a cell drives: the program under test (the PyTorch and CUDA
package `mpir_fft_tpu_torch`, imported only when one is built), and the
control, the plain reference put in the program's place a precision lower.

Each is built for one configuration and called on digit tensors already on
the device: `op(a, b)` for a product, `op(x)` for a square mod 2^N+1.  Its
`route` holds the plan's sizes from which the rooflines' least bytes are
worked out (metrics/*_roofline.py), and `describe()` the line a run prints
before its window."""

from __future__ import annotations

import torch

from bignum_bench import reference

DIGIT_BITS = 16


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def mul_route(bits_a: int, bits_b: int, C: int, t: int, L: int) -> dict:
    """A product's sizes: operands of bits_a / bits_b bits, conv_len C,
    t spectrum rows kept (trunc_mfa), rings of L digits."""
    return {"kind": "mul", "square": False, "bits_a": bits_a, "bits_b": bits_b,
            "La": cdiv(bits_a, DIGIT_BITS), "Lb": cdiv(bits_b, DIGIT_BITS),
            "C": C, "t": t, "L": L, "out_digits": cdiv(bits_a + bits_b, DIGIT_BITS)}


def sqrmod_route(N: int, m: int, Lp: int) -> dict:
    """A square mod 2^N+1 split into m coefficients, on inner rings of Lp
    digits (m = 1, Lp = N/16 where the base leaf takes the ring whole)."""
    return {"kind": "sqrmod", "square": True, "N": N, "LN": N // DIGIT_BITS, "m": m, "Lp": Lp}


class PortMul:
    """The port's product on digits on the device, on the route mul()
    takes: models.mul._select_plan, then models.mul._driver("flagship")."""

    def __init__(self, bits_a: int, bits_b: int, device):
        from mpir_fft_tpu_torch.models import mul as port_mul
        from mpir_fft_tpu_torch.utils import tune

        self.plan = port_mul._select_plan(bits_a, bits_b, "flagship", device)
        cached = (tune.cached_plan(bits_a, bits_b, "flagship", device)
                  if port_mul._tune_enabled() else None)
        self.plan_source = "tune cache" if cached is not None and cached == self.plan \
            else "analytic"
        self.staged = port_mul.flagship_is_staged(self.plan)
        self.huge = port_mul.flagship_is_huge(self.plan)
        self.run = port_mul._driver("flagship", self.plan)
        p = self.plan
        self.route = mul_route(bits_a, bits_b, p.conv_len, p.trunc_mfa, p.W // DIGIT_BITS)

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.run(a, b)

    def describe(self) -> dict:
        p = self.plan
        return {"system": "mpir_fft_tpu_torch flagship", "plan_source": self.plan_source,
                "plan": {"depth": p.depth, "w": p.w, "L": p.W // DIGIT_BITS,
                         "conv": p.conv_len, "trunc_mfa": p.trunc_mfa, "bits1": p.bits1},
                "route": "out of core" if self.huge else "staged" if self.staged else "whole"}


class PortSqrmod:
    """The port's public mulmod(x, x, N, canonical=True)."""

    def __init__(self, N: int, device):
        import mpir_fft_tpu_torch
        from mpir_fft_tpu_torch.ops.mulmod import inner_plan

        self.N = N
        self.mulmod = mpir_fft_tpu_torch.mulmod
        self.plan = inner_plan(N)
        p = self.plan
        self.route = (sqrmod_route(N, 1, N // DIGIT_BITS) if p is None
                      else sqrmod_route(N, p.m, p.Lp))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.mulmod(x, x, self.N, canonical=True)

    def describe(self) -> dict:
        p = self.plan
        return {"system": "mpir_fft_tpu_torch.mulmod", "plan_source": "analytic",
                "plan": None if p is None else {"m": p.m, "b": p.b, "Lp": p.Lp, "wp": p.wp}}


class ControlMul:
    """The control: the reference's product in `dtype` in the program's place."""

    def __init__(self, bits_a: int, bits_b: int, device, dtype=torch.float32):
        self.dtype = dtype
        self.route = mul_route(bits_a, bits_b, 0, 0, 0)

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return reference.mul_digits(a, b, self.dtype)[0].to(torch.int32)

    def describe(self) -> dict:
        return {"system": f"control: the reference in {self.dtype}"}


class ControlSqrmod:
    """The control: the reference's square mod 2^N+1 in `dtype`."""

    def __init__(self, N: int, device, dtype=torch.float32):
        self.dtype = dtype
        self.route = sqrmod_route(N, 1, N // DIGIT_BITS)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return reference.sqrmod_fermat(x, self.dtype)[0].to(torch.int32)

    def describe(self) -> dict:
        return {"system": f"control: the reference in {self.dtype}"}


SYSTEMS = {("mul", "port"): PortMul, ("sqrmod_fermat", "port"): PortSqrmod,
           ("mul", "control"): ControlMul, ("sqrmod_fermat", "control"): ControlSqrmod}


def build(config: dict, which: str, device):
    """The system `which` ("port" or "control") for the configuration."""
    op = config["operation"]
    cls = SYSTEMS[(op, which)]
    if op == "mul":
        return cls(config["bits_a"], config["bits_b"], device)
    return cls(config["N"], device)
