"""Multi-device sharding of the MFA multiply on torch.distributed
(counterpart of mpir_fft_tpu/parallel/mfa_sharded.py).

The reference shards the column axis j1 of the (n2, n1, L) coefficient
tensor over a device mesh during the column pass and the row axis n2 during
the row pass, with XLA inserting the all-to-all at the switch.  Here the
same program is SPMD and explicit: every rank of a process group calls the
same function on the same (replicated) inputs, each rank holds its own
block, the column <-> row boundary is one `all_to_all_single`
(`ShardCtx.to_rows` / `to_cols`), and the result is whole on every rank
(`ShardCtx.gather`), as the reference's in_shardings / out_shardings=repl.

  ShardCtx            the group, rank, world size, device and backend, and
                      the counts of the exchanges it ran with their bytes
  sharded_mul_fn      the mfa / mfa_trunc / flagship drivers sharded
                      (staged flagship plans: models.mul._staged_flagship)
  sharded_mul_many_fn the data-parallel batch: k/ndev pairs a rank, no
                      exchange until the final gather
  *_step              one exact product each on small shapes, checked
                      against Python ints (parallel/dryrun.py runs them)

Transport: both backends take the device's tensors -- NCCL on the card
(one rank a GPU: NCCL refuses two ranks on one device), gloo on the CPU
and on the card, where gloo stages CUDA tensors through host memory inside
its collectives (checked on an H100 with torch 2.11).  gloo has no int16,
so every exchange moves the tensors' bytes (int8 views)."""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from mpir_fft_tpu_torch.ops.limb import DIGIT_BITS, digits_from_int, int_from_digits
from mpir_fft_tpu_torch.utils.interop import digits_to_tensor, tensor_to_digits
from mpir_fft_tpu_torch.utils.params import cdiv, plan_for_depth


class ShardCtx:
    """A process group as the sharding context of the MFA drivers (the
    reference's ShardCtx over a mesh axis).  Blocks: a column block [...,
    n1/ndev, R, L] holds columns [rank n1/ndev, (rank+1) n1/ndev) of R rows;
    a row block [..., R/ndev, n1, L] rows [rank R/ndev, (rank+1) R/ndev).
    `stats` counts the exchanges this rank ran, the bytes it sent into them
    and their host-clock ms (the device synchronized before and after
    each, so the ms are the exchange's own)."""

    transport = "device"

    def __init__(self, group=None, device="cuda"):
        self.group = group if group is not None else dist.group.WORLD
        self.rank = dist.get_rank(self.group)
        self.ndev = dist.get_world_size(self.group)
        self.backend = dist.get_backend(self.group)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ShardCtx: asked for a CUDA device, and this process has none")
        if self.backend not in ("gloo", "nccl"):
            raise ValueError(f"ShardCtx: backend {self.backend!r}; gloo or nccl")
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("ShardCtx: nccl exchanges CUDA tensors only")
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = {"all_to_all": 0, "all_gather": 0, "bytes": 0, "ms": 0.0}

    def local(self, n: int) -> int:
        """A rank's share of an axis of n: n / ndev, which must be whole."""
        if n % self.ndev:
            raise ValueError(f"ShardCtx: {self.ndev} ranks do not divide an axis of {n}")
        return n // self.ndev

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, kind: str, sent: torch.Tensor, collective) -> None:
        self._sync()
        t = time.perf_counter()
        collective()
        self._sync()
        self.stats["ms"] += (time.perf_counter() - t) * 1e3
        self.stats[kind] += 1
        self.stats["bytes"] += sent.numel()

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [ndev, ...]: chunk j goes to rank j; returns [ndev, ...], chunk
        i from rank i."""
        assert x.shape[0] == self.ndev, (tuple(x.shape), self.ndev)
        src = x.contiguous().view(torch.int8)
        out = torch.empty_like(src)
        self._run("all_to_all", src,
                  lambda: dist.all_to_all_single(out, src, group=self.group))
        return out.view(x.dtype)

    def gather(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Every rank's x concatenated along `axis`, in rank order, on every
        rank (the final all-gather)."""
        axis %= x.dim()
        src = x.contiguous().view(torch.int8)
        buf = src.new_empty((self.ndev,) + tuple(src.shape))
        self._run("all_gather", src,
                  lambda: dist.all_gather(list(buf.unbind(0)), src, group=self.group))
        out = buf.view(x.dtype).movedim(0, axis)
        return out.reshape(x.shape[:axis] + (-1,) + x.shape[axis + 1:])

    def to_rows(self, x: torch.Tensor) -> torch.Tensor:
        """A column block [..., n1/ndev, R, L] -> the row block [..., R/ndev,
        n1, L]: one all-to-all."""
        lead, (nl, R, L) = x.shape[:-3], x.shape[-3:]
        k, m = len(lead), self.local(R)
        send = x.reshape(lead + (nl, self.ndev, m, L)).movedim(k + 1, 0)
        got = self.all_to_all(send)                 # [ndev (their columns), ..., nl, m, L]
        got = got.permute(*range(1, k + 1), k + 2, 0, k + 1, k + 3)
        return got.reshape(lead + (m, self.ndev * nl, L))

    def to_cols(self, x: torch.Tensor) -> torch.Tensor:
        """A row block [..., m, n1, L] -> the column block [..., n1/ndev,
        ndev m, L]: one all-to-all, the inverse of to_rows."""
        lead, (m, n1, L) = x.shape[:-3], x.shape[-3:]
        k, nl = len(lead), self.local(n1)
        send = x.reshape(lead + (m, self.ndev, nl, L))
        send = send.permute(k + 1, *range(k), k + 2, k, k + 3)
        got = self.all_to_all(send)                 # [ndev (their rows), ..., nl, m, L]
        got = got.permute(*range(1, k + 1), k + 1, 0, k + 2, k + 3)
        return got.reshape(lead + (nl, self.ndev * m, L))

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x (int32), whole on every rank: an
        all-to-all of ndev slices, each rank sums its slice, one
        all-gather."""
        flat = x.reshape(-1)
        pad = (-flat.numel()) % self.ndev
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        got = self.all_to_all(flat.reshape(self.ndev, -1))
        part = got.sum(dim=0, dtype=torch.int64).to(x.dtype)
        return self.gather(part, 0)[:x.numel()].reshape(x.shape)


def sharded(ctx: ShardCtx | None, n1: int) -> ShardCtx | None:
    """ctx where its ranks divide the plan's n1 columns, else None: the
    drivers then run unsharded on every rank (the reference's fallback where
    the mesh does not divide n1, mfa.py:104-116)."""
    return ctx if ctx is not None and n1 % ctx.ndev == 0 else None


def sharded_mul_fn(ctx: ShardCtx, plan, driver: str = "mfa"):
    """run(da, db=None) -> the product's digits, whole on every rank: the
    driver mfa, mfa_trunc or flagship with its columns and rows sharded over
    ctx (db None: the square, flagship only); flagship plans that stage
    (models.mul.flagship_is_staged) run the sharded staged pipeline (the
    reference's :66-91).  da, db: the same digit tensors on every rank."""
    from mpir_fft_tpu_torch.models.mul import (_staged_flagship, flagship_is_staged,
                                               mpn_mul_flagship, mpn_mul_mfa, mpn_mul_mfa_trunc,
                                               mpn_sqr_flagship)

    base = {"mfa": mpn_mul_mfa, "mfa_trunc": mpn_mul_mfa_trunc, "flagship": mpn_mul_flagship}
    if driver not in base:
        raise ValueError(f"sharded_mul_fn: driver {driver!r}; one of {sorted(base)}")
    if driver == "flagship" and flagship_is_staged(plan):
        return _staged_flagship(plan, ctx)

    def run(da, db=None):
        if db is not None:
            return base[driver](da, db, plan, ctx=ctx)
        if driver != "flagship":
            raise ValueError(f"sharded_mul_fn: the {driver} driver squares no operand")
        return mpn_sqr_flagship(da, plan, ctx=ctx)

    return run


def sharded_mul_many_fn(ctx: ShardCtx, plan, driver: str = "flagship"):
    """run(da, db) -> the products' digits [k, out], whole on every rank:
    the data-parallel batch (the reference's :94-112).  da [k, La], db [k,
    Lb] the same on every rank; rank r runs the single-device driver on
    pairs [r k/ndev, (r+1) k/ndev) -- no exchange until the final gather.
    k % ndev != 0 raises ValueError."""
    from mpir_fft_tpu_torch.models.mul import DRIVERS

    base, _ = DRIVERS[driver]

    def run(da, db):
        k = da.shape[0]
        if k % ctx.ndev or db.shape[0] != k:
            raise ValueError(f"sharded_mul_many_fn: {k} pairs over {ctx.ndev} ranks")
        kl = k // ctx.ndev
        mine = slice(ctx.rank * kl, (ctx.rank + 1) * kl)
        return ctx.gather(base(da[mine], db[mine], plan), 0)

    return run


# ---------------------------------------------------------------------------
# Steps: one exact product each on small shapes (the reference's :115-216)
# ---------------------------------------------------------------------------

def _operand(rng: np.random.Generator, bits: int) -> int:
    return int.from_bytes(rng.bytes(bits // 8), "little") | 1


def _on(ctx: ShardCtx, v: int, bits: int) -> torch.Tensor:
    return digits_to_tensor(digits_from_int(v, cdiv(bits, DIGIT_BITS)), ctx.device)


def _step_plan(ctx: ShardCtx, bits: int, sqrt2: bool):
    """The steps' plan: deep enough that the ranks divide n1."""
    depth = max(5, 2 * max(1, (ctx.ndev - 1).bit_length()))
    plan = plan_for_depth(bits, bits, depth, sqrt2=sqrt2)
    assert plan.n1 % ctx.ndev == 0, (plan.n1, ctx.ndev)
    return plan


def sharded_mul_step(ctx: ShardCtx, bits: int = 1 << 14, driver: str = "mfa") -> np.ndarray:
    """One sharded multiply of two seeded bits-bit operands, held equal to
    Python's product; returns its digits."""
    plan = _step_plan(ctx, bits, driver == "flagship")
    rng = np.random.default_rng(0)
    a, b = _operand(rng, bits), _operand(rng, bits)
    out = tensor_to_digits(sharded_mul_fn(ctx, plan, driver)(_on(ctx, a, bits), _on(ctx, b, bits)))
    assert int_from_digits(out) == a * b, f"sharded {driver} multiply mismatch"
    return out


def sharded_staged_mul_step(ctx: ShardCtx, bits: int = 1 << 14) -> tuple[np.ndarray, np.ndarray]:
    """One sharded STAGED flagship multiply and square (staging forced on at
    a small plan), each held equal to Python's; returns their digits."""
    import mpir_fft_tpu_torch.models.mul as M

    plan = _step_plan(ctx, bits, True)
    rng = np.random.default_rng(2)
    a, b = _operand(rng, bits), _operand(rng, bits)
    old = M._STAGED_THRESHOLD_ELEMS
    M._STAGED_THRESHOLD_ELEMS = 0
    try:
        run = sharded_mul_fn(ctx, plan, "flagship")
        prod = tensor_to_digits(run(_on(ctx, a, bits), _on(ctx, b, bits)))
        sq = tensor_to_digits(run(_on(ctx, a, bits)))
    finally:
        M._STAGED_THRESHOLD_ELEMS = old
    assert int_from_digits(prod) == a * b, "sharded staged flagship multiply mismatch"
    assert int_from_digits(sq) == a * a, "sharded staged flagship squaring mismatch"
    return prod, sq


def sharded_mul_many_step(ctx: ShardCtx, bits: int = 1 << 13) -> np.ndarray:
    """One data-parallel batch of ndev multiplies, each held equal to
    Python's; returns the digits [ndev, out]."""
    plan = plan_for_depth(bits, bits, 3, sqrt2=True)
    rng = np.random.default_rng(1)
    pairs = [(_operand(rng, bits), _operand(rng, bits)) for _ in range(ctx.ndev)]
    da = torch.stack([_on(ctx, a, bits) for a, _ in pairs])
    db = torch.stack([_on(ctx, b, bits) for _, b in pairs])
    out = tensor_to_digits(sharded_mul_many_fn(ctx, plan, "flagship")(da, db))
    for i, (a, b) in enumerate(pairs):
        assert int_from_digits(out[i]) == a * b, f"DP batch row {i} mismatch"
    return out


def huge_mul_step(bits: int = 1 << 15, ctx: ShardCtx | None = None,
                  device=None) -> np.ndarray:
    """One out-of-core multiply (models/huge.py) at depth 6 with chunks
    small enough that the chunk loops iterate, sharded over ctx where
    given, held equal to Python's product; returns its digits."""
    import mpir_fft_tpu_torch.models.huge as H

    plan = plan_for_depth(bits, bits, 6, sqrt2=True)
    assert H.huge_serves(plan), plan
    dev = ctx.device if ctx is not None else torch.device(device or "cuda")
    rng = np.random.default_rng(3)
    a, b = _operand(rng, bits), _operand(rng, bits)
    da = digits_to_tensor(digits_from_int(a, cdiv(bits, DIGIT_BITS)), dev)
    db = digits_to_tensor(digits_from_int(b, cdiv(bits, DIGIT_BITS)), dev)
    old = H.CHUNK_BYTES, H.PW_CHUNK_BYTES
    H.CHUNK_BYTES = 1 << 14
    H.PW_CHUNK_BYTES = (1 << 16) if ctx is not None else (1 << 13)
    try:
        out = tensor_to_digits(H.mul_huge(da, db, plan, ctx=ctx))
    finally:
        H.CHUNK_BYTES, H.PW_CHUNK_BYTES = old
    assert int_from_digits(out) == a * b, "out-of-core multiply mismatch"
    return out
