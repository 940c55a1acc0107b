"""The plain reference against Python ints, its exact carry resolution, and
its control a precision lower coming out wrong."""

import random

import pytest
import torch

from bignum_bench import reference


def digits(x: int, n: int) -> torch.Tensor:
    return torch.tensor([(x >> (16 * i)) & 0xFFFF for i in range(n)], dtype=torch.int64)


def value(d: torch.Tensor) -> int:
    return sum(int(v) << (16 * i) for i, v in enumerate(d.tolist()))


@pytest.mark.parametrize("bits_a,bits_b", [(16, 16), (17, 200), (1000, 1000), (4096, 65536),
                                           (100003, 70001)])
def test_products_equal_python_ints(bits_a, bits_b):
    rnd = random.Random(bits_a * 7 + bits_b)
    a, b = rnd.getrandbits(bits_a) | 1 << (bits_a - 1), rnd.getrandbits(bits_b)
    prod, roundoff = reference.mul_digits(digits(a, -(-bits_a // 16)), digits(b, -(-bits_b // 16)))
    assert value(prod) == a * b and roundoff < reference.ROUNDOFF_LIMIT


def test_product_of_all_ones_ripples():
    a = (1 << 4096) - 1
    prod, _ = reference.mul_digits(digits(a, 256), digits(a, 256))
    assert value(prod) == a * a


@pytest.mark.parametrize("N", [64, 1024, 1 << 16])
def test_squares_mod_fermat_equal_python_ints(N):
    rnd = random.Random(N)
    p = (1 << N) + 1
    L = N // 16
    for x in [rnd.getrandbits(N), rnd.getrandbits(N), (1 << N) - 1, 0, 1, 1 << (N - 1),
              (1 << (N // 2)), (1 << (N // 2)) + 1]:
        out, _ = reference.sqrmod_fermat(digits(x, L))
        got = (1 << N) if int(out[0]) == -1 and not out[1:].any() else value(out)
        assert got == x * x % p, (N, x)
        assert int(out[1:].min()) >= 0 and int(out.max()) < 1 << 16


def test_square_of_minus_one_form_and_into_it():
    N, L = 1024, 64
    minus1 = torch.zeros(L, dtype=torch.int64)
    minus1[0] = -1
    out, _ = reference.sqrmod_fermat(minus1)
    assert value(out) == 1
    # x^2 = 2^N = -1 mod 2^N+1 for x = 2^(N/2)
    out, _ = reference.sqrmod_fermat(digits(1 << (N // 2), L))
    assert int(out[0]) == -1 and not out[1:].any()


@pytest.mark.parametrize("cin", [0, 1])
def test_resolve_settles_long_ripples(cin):
    m = (1 << 16) - 1
    v = torch.tensor([m + 1] + [m] * 1000 + [3, 2 * m, m, m, 0], dtype=torch.int64)
    out, cout = reference.resolve(v, cin)
    want = sum(int(d) << (16 * i) for i, d in enumerate(v.tolist())) + cin
    got = value(out) + (cout << (16 * v.numel()))
    assert got == want and int(out.max()) <= m


def test_control_in_float32_is_wrong_at_test_sizes():
    rnd = random.Random(5)
    a, b = rnd.getrandbits(1 << 18), rnd.getrandbits(1 << 18)
    da, db = digits(a, 1 << 14), digits(b, 1 << 14)
    right, _ = reference.mul_digits(da, db)
    wrong, roundoff = reference.mul_digits(da, db, torch.float32)
    assert value(right) == a * b and not torch.equal(wrong, right)
    N = 1 << 16
    x = digits(rnd.getrandbits(N), N // 16)
    assert not torch.equal(reference.sqrmod_fermat(x, torch.float32)[0],
                           reference.sqrmod_fermat(x)[0])
