"""The port's command-line tool (mpir_fft_tpu_torch/cli.py) and its native
layer (mpir_fft_tpu_torch/native/) on the CPU: `mul` byte for byte against
the reference CLI, the other subcommands against Python ints, and the byte
<-> digit marshalling against the reference's."""

import ctypes.util
import json
import random
import shutil

import jax
import numpy as np
import pytest
import torch

from mpir_fft_tpu import cli as jcli
from mpir_fft_tpu import native as jnative
from mpir_fft_tpu_torch import cli, native
from mpir_fft_tpu_torch.utils.params import choose_params


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv("MPIR_FFT_TUNE_CACHE", str(path))
    monkeypatch.delenv("MPIR_FFT_TUNE", raising=False)
    return path


def _write(path, value: int, nbytes: int):
    path.write_bytes(value.to_bytes(nbytes, "little"))
    return str(path)


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_mul_byte_identical_to_reference(tmp_path, cache_file, capsys):
    """`mul` through files writes the reference CLI's bytes exactly (2 bytes
    a digit of out_len_digits, high zero digits kept), and prints its keys."""
    rnd = random.Random(17)
    a, b = rnd.getrandbits(24000), rnd.getrandbits(9000)
    fa, fb = _write(tmp_path / "a.bin", a, 3000), _write(tmp_path / "b.bin", b, 1125)
    assert cli.main(["mul", fa, fb, str(tmp_path / "port.bin"), "--device", "cpu"]) == 0
    port = _last_json(capsys)
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        assert jcli.main(["mul", fa, fb, str(tmp_path / "ref.bin")]) == 0
    finally:   # the reference CLI retunes the compile cache for the process
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_secs)
    ref = _last_json(capsys)
    got, want = (tmp_path / "port.bin").read_bytes(), (tmp_path / "ref.bin").read_bytes()
    assert got == want
    assert int.from_bytes(got, "little") == a * b
    assert {k: port[k] for k in ("bits_a", "bits_b", "driver", "out_bytes")} == {
        k: ref[k] for k in ("bits_a", "bits_b", "driver", "out_bytes")}
    assert set(port) == set(ref)


@pytest.mark.parametrize("N", [20000, 20480])
def test_cli_mulmod_matches_python(N, tmp_path, capsys):
    rnd = random.Random(N)
    p = (1 << N) + 1
    a, b = rnd.randrange(p), (1 << N)          # b is -1 mod p: the top form
    fa = _write(tmp_path / "a.bin", a, (N + 8) // 8)
    fb = _write(tmp_path / "b.bin", b, (N + 8) // 8)
    out = tmp_path / "r.bin"
    assert cli.main(["mulmod", fa, fb, str(out), "--nbits", str(N), "--device", "cpu"]) == 0
    assert _last_json(capsys)["out_bytes"] == (N + 8) // 8 + 1
    assert out.read_bytes() == ((a * b) % p).to_bytes((N + 8) // 8 + 1, "little")


def test_cli_selftest(cache_file, capsys):
    assert cli.main(["selftest", "--bits", "20000", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("oracle: ")
    assert [ln.split() for ln in lines[1:]] == [
        [d, "OK"] for d in ("radix2", "sqrt2", "trunc", "trunc_sqrt2", "mfa", "mfa_trunc",
                            "flagship")]


@pytest.mark.parametrize("batch", [1, 3])
def test_cli_bench(batch, cache_file, capsys):
    assert cli.main(["bench", "--bits", "20000", "--reps", "2", "--batch", str(batch),
                     "--device", "cpu"]) == 0
    r = _last_json(capsys)
    plan = choose_params(20000, 20000, True)
    assert r["exact"] is True and r["batch"] == batch and r["clock"] == "host"
    assert (r["plan"]["depth"], r["plan"]["w"]) == (plan.depth, plan.w)
    assert len(r["device_ms_all"]) == len(r["wall_ms_all"]) == 2 and r["device"] == "cpu"


def test_cli_residues_refuse_noncanonical_digits():
    v = random.Random(3).getrandbits(4000)
    d = torch.from_numpy(np.frombuffer(v.to_bytes(500, "little"), "<u2").astype(np.int32))
    assert cli.residues(d) == tuple(v % p for p in cli.PRIMES_61)
    d[5] += 1 << 16          # the same value, one digit out of range
    with pytest.raises(ValueError, match="not canonical"):
        cli.residues(d)


def _is_prime(n: int) -> bool:
    d, r = n - 1, 0
    while d % 2 == 0:
        d, r = d // 2, r + 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def test_primes_61_are_the_four_largest_below_2_61():
    below = [n for n in range((1 << 61) - 1, cli.PRIMES_61[-1] - 1, -1) if _is_prime(n)]
    assert tuple(below) == cli.PRIMES_61


def test_cli_tune_then_cached(cache_file, capsys):
    assert cli.main(["tune", "--bits", "20000", "--reps", "1", "--device", "cpu"]) == 0
    r = _last_json(capsys)
    assert r["cached"] is False and r["device"] == "cpu" and len(r["candidates"]) == 5
    assert cli.main(["tune", "--bits", "20000", "--device", "cpu"]) == 0
    again = _last_json(capsys)
    assert again["cached"] is True and (again["depth"], again["w"]) == (r["depth"], r["w"])


def test_cli_profile(cache_file, capsys):
    assert cli.main(["profile", "--bits", "20000", "--reps", "1", "--device", "cpu"]) == 0
    r = _last_json(capsys)
    assert r["clock"] == "host" and r["total_s"] > 0 and r["plan"]["depth"] == 6
    assert cli.main(["profile", "--transforms", "--depth", "4", "--w", "2", "--reps", "1",
                     "--device", "cpu"]) == 0
    r = _last_json(capsys)
    assert (r["depth"], r["w"], r["L"]) == (4, 2, 2) and r["fft_mfa_s"] > 0


def test_cli_baseline(capsys):
    rc = cli.main(["baseline", "--bits", "100000", "--reps", "1"])
    r = _last_json(capsys)
    if native.gmp_mul(b"\x01", b"\x01") is None:
        assert rc == 1 and "unavailable" in r["error"]
    else:
        assert rc == 0 and r["limbs"] == 1563 and r["value"] > 0
        assert r["metric"] == "gmp_mpn_mul_100000bit_walltime"


@pytest.mark.parametrize("nbytes,L", [(2000, 1000), (2001, 1001), (2001, 1200), (2001, 700),
                                      (1, 1), (0, 3)])
def test_digits_from_bytes_matches_reference(nbytes, L):
    """Odd byte counts pad a zero byte, digits past the buffer are 0 and
    bytes past 2 L are dropped, as the reference's marshal layer does; the
    bytes come back 2 a digit."""
    buf = random.Random(nbytes).randbytes(nbytes)
    got = native.digits_from_bytes(buf, L, "cpu")
    assert got.dtype == torch.int32 and got.shape == (L,)
    assert np.array_equal(got.numpy(), jnative.digits_from_bytes(buf, L))
    back = native.bytes_from_digits(got)
    assert back == jnative.bytes_from_digits(jnative.digits_from_bytes(buf, L))
    assert back[:min(nbytes, 2 * L)] == buf[:2 * L] and len(back) == 2 * L


@pytest.mark.parametrize("bad", [-1, 1 << 16, -(1 << 20)])
def test_bytes_from_digits_refuses_noncanonical(bad):
    d = torch.tensor([5, bad, 7], dtype=torch.int32)
    with pytest.raises(ValueError, match="digits not canonical"):
        native.bytes_from_digits(d)


def test_gmp_mul_matches_python():
    rnd = random.Random(11)
    a, b = rnd.getrandbits(100_003), rnd.getrandbits(7)
    ab, bb = a.to_bytes(12501, "little"), b.to_bytes(1, "little")
    got = native.gmp_mul(ab, bb)
    if got is None:     # the host has no cc or no libgmp.so.10
        assert shutil.which("cc") is None or ctypes.util.find_library("gmp") is None
        return
    assert len(got) == 12502 and int.from_bytes(got, "little") == a * b
    assert int.from_bytes(native.gmp_mul(bb, ab), "little") == a * b
    assert native.gmp_mul(b"", ab) == bytes(12501)
