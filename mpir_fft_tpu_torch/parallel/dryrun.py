"""Ranks spawned on one host, and the multi-device dry run (counterpart of
__graft_entry__.dryrun_multichip).

    python -m mpir_fft_tpu_torch.parallel.dryrun 4 --device cpu

`run_ranks(n, fn, args)` starts n processes with the `spawn` method (never
`fork`: a parent that has initialised CUDA cannot fork it), joins them into
one torch.distributed group through a FileStore in a temporary directory
(no network), and returns [fn(ctx, *args) of each rank], ctx the rank's
ShardCtx.  On CUDA every rank takes device rank % device_count, so with one
card all ranks share it (gloo; NCCL refuses two ranks on one device).  fn
and its results cross between processes pickled, so fn lives at module level
and returns host objects.  A rank that raises, dies or outlasts the timeout
fails the call, and the other ranks are stopped.

`dryrun_multichip(n_ranks)` runs the reference's six steps (flagship,
mfa_trunc, staged, the data-parallel batch, out of core, sharded out of
core) on n_ranks ranks, each held equal to Python's product, and prints
the reference's line."""

from __future__ import annotations

import argparse
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from mpir_fft_tpu_torch.parallel import mfa_sharded as S


def default_backend(n_ranks: int, device) -> str:
    """nccl where every rank has a card of its own, else gloo."""
    if torch.device(device).type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(rank: int, n_ranks: int, store: str, device: str, backend: str, fn, args,
               out: multiprocessing.Queue) -> None:
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            if not torch.cuda.is_available():
                raise RuntimeError(f"rank {rank}: asked for {device}, and finds no CUDA device")
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        extra = {"device_id": dev} if backend == "nccl" else {}
        try:
            dist.init_process_group(backend, store=dist.FileStore(store, n_ranks), rank=rank,
                                    world_size=n_ranks, **extra)
            result = fn(S.ShardCtx(device=dev), *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        out.put((rank, True, result))
    except Exception:
        out.put((rank, False, traceback.format_exc()))


def run_ranks(n_ranks: int, fn, args=(), device="cuda", backend: str | None = None,
              timeout: float = 600.0) -> list:
    """[fn(ctx, *args) of rank 0, 1, ...] from n_ranks spawned ranks."""
    backend = backend or default_backend(n_ranks, device)
    mp = multiprocessing.get_context("spawn")
    results: queue.Queue = mp.Queue()
    done: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [mp.Process(target=_rank_main,
                            args=(r, n_ranks, os.path.join(tmp, "store"), str(device), backend,
                                  fn, tuple(args), results), daemon=True)
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(done) < n_ranks:
                left = deadline - time.monotonic()
                if left <= 0:
                    late = sorted(set(range(n_ranks)) - set(done))
                    raise TimeoutError(f"run_ranks: ranks {late} did not finish in {timeout:.0f} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 2.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"run_ranks: ranks {dead} exited without a result "
                                           f"(exit codes {[procs[r].exitcode for r in dead]})")
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} failed:\n{payload}")
                done[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=30 if len(done) == n_ranks else 0.5)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [done[r] for r in range(n_ranks)]


def exchange_check(ctx: S.ShardCtx) -> str:
    """One column block to rows and back on the ranks' device, checked:
    the group's exchanges work.  Returns the transport."""
    nl, m, L = 2, 3, 4
    x = torch.arange(nl * m * ctx.ndev * L, dtype=torch.int32, device=ctx.device)
    x = (x.reshape(nl, m * ctx.ndev, L) + 1000 * ctx.rank).contiguous()
    rows = ctx.to_rows(x)
    assert rows.shape == (m, nl * ctx.ndev, L)
    assert torch.equal(ctx.to_cols(rows), x)
    return ctx.transport


def _steps(ctx: S.ShardCtx) -> None:
    """The reference's dry-run steps (__graft_entry__.py:96-109)."""
    S.sharded_mul_step(ctx, bits=1 << 14, driver="flagship")
    S.sharded_mul_step(ctx, bits=1 << 14, driver="mfa_trunc")
    S.sharded_staged_mul_step(ctx, bits=1 << 14)
    S.sharded_mul_many_step(ctx)
    S.huge_mul_step(bits=1 << 15, device=ctx.device)
    S.huge_mul_step(bits=1 << 15, ctx=ctx)


def dryrun_multichip(n_ranks: int, device="cuda", backend: str | None = None,
                     timeout: float = 600.0) -> None:
    """Run the six steps on n_ranks spawned ranks (all exact, or raise)."""
    run_ranks(n_ranks, _steps, (), device, backend, timeout)
    print(f"dryrun_multichip OK on {n_ranks} devices "
          "(flagship, mfa_trunc, staged, DP batch, out-of-core, sharded out-of-core)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ranks", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    opts = ap.parse_args()
    dryrun_multichip(opts.ranks, opts.device, opts.backend)
