"""Nothing the harness imports is JAX or the JAX package (top-level names
compared whole), and the reference imports nothing of the program."""

import subprocess
import sys

from bignum_bench import harness, spec

PROBE = """
import sys
sys.path.insert(0, {repo!r})
import {modules}
from bignum_bench import systems
systems.PortMul(40000, 40000, "cpu"); systems.PortSqrmod(1 << 16, "cpu")
print(",".join(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def top_levels(modules: str, build: bool = True) -> set[str]:
    code = PROBE.format(repo=str(spec.REPO), modules=modules)
    if not build:
        code = code.replace('systems.PortMul(40000, 40000, "cpu"); '
                            'systems.PortSqrmod(1 << 16, "cpu")', "")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=spec.REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    return set(res.stdout.strip().splitlines()[-1].split(","))


def test_the_harness_loads_no_jax():
    names = top_levels("bignum_bench.run, bignum_bench.harness, bignum_bench.control")
    assert "mpir_fft_tpu_torch" in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = top_levels("bignum_bench.reference", build=False)
    assert not names & (set(harness.FORBIDDEN) | {"mpir_fft_tpu_torch"})


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["mpir_fft_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "mpir_fft_tpu.ops", "flax"]) == [
        "flax", "jax.numpy", "mpir_fft_tpu.ops"]
