"""The comparison that decides `correct`: what the timed path produced,
held digit for digit against the plain reference (reference.py), which
works every answer out again from the inputs the benchmark made.

Each number compared has the limit 0: the system promises exact products
and canonical residues, so one wrong digit fails the run.

  wrong_outputs  outputs of the window that are not the reference's (a
                 closed loop: products, those that could not be verified
                 counted with them; a chain: its last residue, 0 or 1)
  wrong_digits   digits that differ from the reference's in the outputs
                 the reference judged

The reference's own roundoff is checked as well: past ROUNDOFF_LIMIT it
cannot vouch for an answer, and the judge raises rather than rule."""

from __future__ import annotations

import time

import torch

from bignum_bench import reference

LIMITS = {"wrong_outputs": 0, "wrong_digits": 0}


def digits_differ(out: torch.Tensor, ref: torch.Tensor) -> int:
    """Digits in which two digit vectors differ, the shorter read as padded
    with zero digits (the program may return zero digits on top)."""
    n = max(out.numel(), ref.numel())
    a = torch.zeros(n, dtype=torch.int64, device=ref.device)
    b = torch.zeros(n, dtype=torch.int64, device=ref.device)
    a[: out.numel()] = out.reshape(-1).to(device=ref.device, dtype=torch.int64)
    b[: ref.numel()] = ref.reshape(-1)
    return int((a != b).sum())


def _reference(config: dict, args: tuple) -> tuple[torch.Tensor, float]:
    if config["operation"] == "mul":
        return reference.mul_digits(*args)
    return reference.sqrmod_fermat(*args)


def _guard(roundoff: float) -> None:
    if roundoff >= reference.ROUNDOFF_LIMIT:
        raise ArithmeticError(f"the reference's roundoff {roundoff} reached "
                              f"{reference.ROUNDOFF_LIMIT}: it cannot judge at this size")


def judge_closed(config: dict, inputs: list[tuple], check) -> dict:
    """The kept output of each pool entry against the reference; the
    window's other outputs were compared with the kept ones on the device."""
    wrong_outputs = wrong_digits = 0
    roundoff = 0.0
    t = time.perf_counter()
    differs = check.differs.tolist()
    for j, args in enumerate(inputs):
        wrong_outputs += check.bad_shape[j]
        if not check.have[j]:
            continue
        ref, r = _reference(config, args)
        roundoff = max(roundoff, r)
        _guard(roundoff)
        d = digits_differ(check.kept[j], ref)
        wrong_digits += d
        seen = check.count[j] - check.bad_shape[j]
        # a wrong kept output leaves every output of its entry unverified
        wrong_outputs += seen if d else differs[j]
        del ref
    return {"wrong_outputs": wrong_outputs, "wrong_digits": wrong_digits,
            "failed": wrong_outputs,
            "info": {"judged_by_reference": sum(check.have), "roundoff": roundoff,
                     "reference_s": time.perf_counter() - t}}


def judge_chain(config: dict, x0: torch.Tensor, calls: int, final: torch.Tensor) -> dict:
    """The chain's last residue against the reference's, which squares x0
    as many times again."""
    t = time.perf_counter()
    x, roundoff = x0.to(torch.int64), 0.0
    for _ in range(calls):
        x, r = reference.sqrmod_fermat(x)
        roundoff = max(roundoff, r)
        _guard(roundoff)
    d = digits_differ(final, x)
    # a wrong last residue leaves every call of the chain unverified
    return {"wrong_outputs": int(d > 0), "wrong_digits": d, "failed": calls if d else 0,
            "info": {"judged_by_reference": calls, "roundoff": roundoff,
                     "reference_s": time.perf_counter() - t}}


def checks(numbers: dict) -> dict:
    """{name: {"value": v, "limit": l}} of the numbers compared."""
    return {k: {"value": numbers[k], "limit": lim} for k, lim in LIMITS.items()}


def correct(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
