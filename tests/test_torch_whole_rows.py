"""The whole-row transform's wide rows (64-512 KB: ops/fused.py whole_fits
past WHOLE_BUF_BYTES, held by one CTA or a cluster, whole_cluster) on the
CPU, where fused_transform takes its plain version.

Which route each gap row takes (the rows the reference fuses that took the
ladder before: the flat pair of mul / sqr at 1.2-8x10^5 bits, the MFA rows
at L 512 / 1024, a rank's sharded rows), the rows that stay on the ladder;
one wide row against the reference's fft_radix2 / ifft_radix2 on its
fused_batched kernel (interpret mode); products through those rows exact
against Python's.  Exact: integer arithmetic."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpir_fft_tpu.ops import transforms as jtr
from mpir_fft_tpu.ops.fused import force_pallas
from mpir_fft_tpu_torch.models.mul import mul, sqr
from mpir_fft_tpu_torch.ops import fused as tfused
from mpir_fft_tpu_torch.ops import transforms as ttr
from mpir_fft_tpu_torch.ops.limb import normmod


def _route_spies(monkeypatch):
    """Record (wrapper, kind, shape) of every kernel wrapper call the
    transforms make, without computing (the route is what is tested)."""
    calls = []
    for name in ("fused_transform", "fused_butterfly_ladder", "fused_twiddle_half"):
        def spy(*a, _name=name, **k):
            calls.append((_name, a[0] if isinstance(a[0], str) else None, tuple(a[1].shape)
                          if isinstance(a[0], str) else tuple(a[0].shape)))
            return a[1] if isinstance(a[0], str) else a[0]

        monkeypatch.setattr(ttr, name, spy)
    return calls


# (kind, shape, w): the rows the reference fuses that took the ladder before
# -- mul's stacked forward at 1.5x10^5 / 2x10^5 / 3x10^5 / 5x10^5 (512 KB) /
# 7x10^5 bits and its odd-w inverse at 3x10^5 / 7x10^5; the 6.3x10^7 x
# 5x10^6 plan's MFA rows, forward and inverse; a rank's sharded 10^8 rows
GAP_ROWS = (
    ("fwd", (2, 512, 80), 5), ("fwd", (2, 1024, 64), 2), ("fwd", (2, 2, 512, 80), 5),
    ("inv", (2, 512, 80), 5), ("fwd", (2, 1024, 128), 4), ("fwd", (2, 2, 1024, 96), 3),
    ("inv", (2, 1024, 96), 3), ("fwd", (2, 6, 128, 512), 128), ("fwd", (2, 128, 128, 512), 128),
    ("inv", (6, 128, 512), 128), ("inv", (128, 128, 512), 128), ("fwd", (4, 128, 1024), 256),
    ("inv", (4, 128, 1024), 256),
)


@pytest.mark.parametrize("kind,shape,w", GAP_ROWS)
def test_gap_rows_take_one_whole_launch(monkeypatch, kind, shape, w):
    """Each gap row: one fused_transform call on the flattened batch, no
    ladder and no twiddle pass, with the weights in it where it carries
    them; a cluster holds its row at its batch."""
    calls = _route_spies(monkeypatch)
    C, L = shape[-2], shape[-1]
    W = 16 * L
    x = torch.zeros(shape, dtype=torch.int32)
    fn = ttr.fft_radix2 if kind == "fwd" else ttr.ifft_radix2
    B = int(np.prod(shape[:-2]))
    assert fn(x, w, W).shape == x.shape
    assert calls == [("fused_transform", kind, (B, C, L))]
    calls.clear()
    half = {"pre_half": (0, w)} if kind == "fwd" else {"post_half": (0, -w)}
    fn(x, w, W, **half)
    assert calls == [("fused_transform", kind, (B, C, L))]
    R = tfused.whole_cluster(B, C, L, 132)
    assert R in tfused.WHOLE_CLUSTERS and tfused.whole_smem_bytes(C, R, L) <= tfused.WHOLE_CTA_SMEM


@pytest.mark.parametrize("kind,shape,w,opt", [
    ("fwd", (2, 128, 512), 128, "table"), ("inv", (2, 128, 512), 128, "table"),
    ("inv", (2, 1024, 64), 2, "skip"), ("fwd", (1024, 64), 2, None),
    ("inv", (1024, 128), 4, None), ("fwd", (2, 8192, 128), 4, None),
    ("fwd", (2, 256, 2048), 256, None),
])
def test_wide_rows_that_stay_on_the_ladder(monkeypatch, kind, shape, w, opt):
    """What the whole route does not take, in both packages: a row with a
    cross-twiddle table or skipped inner stages, a lone (2-D) transform,
    rows past the reference's rule ((8192, 128): 4 MB; L 2048): ladder
    groups only."""
    calls = _route_spies(monkeypatch)
    C, L = shape[-2], shape[-1]
    W = 16 * L
    x = torch.zeros(shape, dtype=torch.int32)
    if opt == "table":
        exps = np.arange(C, dtype=np.int64) * 3
        (ttr.fft_radix2 if kind == "fwd" else ttr.ifft_radix2)(x, w, W, exps)
    elif opt == "skip":
        ttr.ifft_radix2(x, w, W, skip_inner=ttr.inner_group(C, L))
    else:
        (ttr.fft_radix2 if kind == "fwd" else ttr.ifft_radix2)(x, w, W)
    assert calls and all(c[0] == "fused_butterfly_ladder" for c in calls), calls


def test_wide_row_matches_reference(rng):
    """(2, 512, 80), the flat pair's row at 3x10^5 bits (160 KB): forward
    and inverse equal to the reference's fft_radix2 / ifft_radix2 mod p,
    which fuses the row (fused_batched in interpret mode under
    force_pallas), and identical to the ladder groups' raw digits."""
    B, C, L, w = 2, 512, 80, 5
    W = 16 * L
    x = rng.integers(-(1 << 17), 1 << 17, (B, C, L)).astype(np.int32)
    tx = torch.from_numpy(x)
    f = ttr.fft_radix2(tx, w, W)
    i = ttr.ifft_radix2(f, w, W)
    with force_pallas(True):
        jf = jtr.fft_radix2(jnp.asarray(x), w, W)
        ji = jtr.ifft_radix2(jnp.asarray(f.numpy()), w, W)
    canon = lambda a: normmod(torch.from_numpy(np.array(a, dtype=np.int32))).numpy()
    assert np.array_equal(canon(f), canon(jf))
    assert np.array_equal(canon(i), canon(ji))
    groups = tfused.ladder_groups(C, L, "fwd")
    y = tx
    for l, kg in groups:
        K = 1 << kg
        y = tfused.ladder_plain("fwd", y.reshape(-1, K, C >> (l + kg), L),
                                tuple(w << (l + j) for j in range(kg)), W).reshape(B, C, L)
    assert torch.equal(f, y)


@pytest.mark.parametrize("op,bits", [("mul", 200_000), ("mul", 300_000), ("mul", 700_000),
                                     ("sqr", 300_000)])
def test_products_through_wide_rows_exact(monkeypatch, op, bits):
    """mul at 2x10^5, 3x10^5 and 7x10^5 bits and sqr at 3x10^5, exact
    against Python's product, their batched flat transforms on the whole
    route (a row of 160-384 KB each); at odd w (3x10^5, 7x10^5) no ladder
    group runs."""
    seen = []
    for name in ("fused_transform", "fused_butterfly_ladder"):
        real = getattr(ttr, name)

        def spy(*a, _real=real, _name=name, **k):
            seen.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(ttr, name, spy)
    rnd = random.Random(bits)
    a = rnd.getrandbits(bits) | (1 << (bits - 1))
    b = rnd.getrandbits(bits) | (1 << (bits - 1))
    if op == "mul":
        assert mul(a, b, device="cpu") == a * b
    else:
        assert sqr(a, device="cpu") == a * a
    assert "fused_transform" in seen
    if bits != 200_000:
        assert "fused_butterfly_ladder" not in seen, seen
