"""Moving plans and digit arrays between the JAX package and the port.

The port imports nothing of JAX: a reference plan crosses as the plain
dict of its dataclass fields, digit arrays as numpy int32."""

from __future__ import annotations

import numpy as np
import torch

from .params import MulPlan, validate


def plan_from_reference(fields: dict) -> MulPlan:
    """The port's plan for a reference MulPlan's fields
    (`dataclasses.asdict(plan)` of mpir_fft_tpu.utils.params.MulPlan)."""
    return validate(MulPlan(**fields))


def digits_to_tensor(digits: np.ndarray, device="cuda") -> torch.Tensor:
    """A numpy digit array as an int32 tensor on `device`."""
    arr = np.ascontiguousarray(digits, dtype=np.int32)
    return torch.from_numpy(arr).to(device)


def tensor_to_digits(t: torch.Tensor) -> np.ndarray:
    """A digit tensor as a numpy int32 array on the host."""
    return t.detach().to("cpu", torch.int32).numpy()
