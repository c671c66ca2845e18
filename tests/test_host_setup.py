"""Host-side set-up: the persistent compile cache's location, the native
helpers built from their C sources, and chip_smoke.py's refusal to run
without an accelerator."""

import os
import shutil
import subprocess
import sys

import pytest

from smcsmc_tpu import _native
from smcsmc_tpu._cache import CHECKOUT_CACHE_DIR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CACHE_PROBE = """
import os, jax
from smcsmc_tpu._cache import enable_compilation_cache
path = enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.jit(lambda x: x * 3.0 + 1.0)(jax.numpy.arange(5.0)).block_until_ready()
print(path)
print(len(os.listdir(path)))
"""


@pytest.mark.parametrize("env_dir", [True, False], ids=["env", "checkout"])
def test_compile_cache_location(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is where compiled programs land
    (the code sets no directory of its own); otherwise they land in the
    fixed <checkout>/.jax_cache, whatever the working directory."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    want = CHECKOUT_CACHE_DIR
    if env_dir:
        want = str(tmp_path / "jaxcache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    path, entries = r.stdout.split()[-2:]
    assert os.path.abspath(path) == os.path.abspath(want)
    assert CHECKOUT_CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    assert int(entries) > 0


@pytest.mark.parametrize(
    "name,symbol",
    [("segscan", "segscan_parse"), ("lookahead", "lookahead_scan")],
)
def test_native_builds_from_source(tmp_path, name, symbol):
    """An empty build directory gets the library compiled from
    native/<name>.c, and a second call reuses it."""
    build_dir = str(tmp_path / "build")
    lib = _native.load(name, symbol, build_dir=build_dir)
    assert lib is not None
    so = _native.library_path(name, build_dir)
    assert os.path.exists(so)
    mtime = os.path.getmtime(so)
    assert _native.build(name, build_dir) == so
    assert os.path.getmtime(so) == mtime


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result line on a
    CPU-only backend, and in a directory that holds nothing else of the
    repository."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, script], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert not os.path.exists(tmp_path / "chiprun_out")
