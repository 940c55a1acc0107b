"""The card's peaks that the rooflines are shares of, with the power limit
they assume.  NVIDIA's data sheet for the H100 SXM5 (80 GB HBM3): HBM at
3.35 TB/s; dense int8 on the tensor cores at 1979 x 10^12 operations per
second (two a multiply-add).  Both hold at the full 700 W power limit; a
card set lower may fall short of them, so every run prints the card's own
limit beside them."""

from __future__ import annotations

import shutil
import subprocess

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
RATED_POWER_W = 700.0


def gpu_line() -> str:
    """`nvidia-smi`'s name and power limit of the card, or why there is none."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    res = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() \
        else f"nvidia-smi failed ({res.returncode})"


def describe() -> dict:
    return {"hbm_bytes_per_s": HBM_BYTES_PER_S, "int8_ops_per_s": INT8_OPS_PER_S,
            "rated_at_power_w": RATED_POWER_W, "card": gpu_line()}
