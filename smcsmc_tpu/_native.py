"""Host-side C helpers (``native/<name>.c``), compiled on first use.

The shared libraries are build products: they are compiled from the
committed sources into ``<checkout>/build/`` (listed in ``.gitignore``) by
the host's C compiler (``$CC``, default ``cc``) the first time they are
needed, or up front by ``make native``.  A library older than its source is
rebuilt.  Callers fall back to their Python oracles when no compiler is
available."""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC_DIR = os.path.join(_ROOT, "native")
BUILD_DIR = os.path.join(_ROOT, "build")


def library_path(name: str, build_dir: str = BUILD_DIR) -> str:
    return os.path.join(build_dir, f"_{name}.so")


def build(name: str, build_dir: str = BUILD_DIR) -> str:
    """Compile ``native/<name>.c`` into ``<build_dir>/_<name>.so`` unless an
    up-to-date library is already there; returns its path.  Raises
    ``OSError``/``CalledProcessError`` when the compiler is missing or
    fails."""
    src = os.path.join(SRC_DIR, f"{name}.c")
    so = library_path(name, build_dir)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(build_dir, exist_ok=True)
    # compile to a private name, then rename: concurrent processes (test
    # workers, chunk processes) may race to build the same library
    tmp = f"{so}.{os.getpid()}.tmp"
    cc = os.environ.get("CC", "cc")
    # portable codegen (no -march=native): the build directory may be
    # shared between hosts
    subprocess.run(
        [cc, "-O3", "-shared", "-fPIC", "-o", tmp, src],
        check=True, capture_output=True,
    )
    os.replace(tmp, so)
    return so


def load(name: str, symbol: str, build_dir: str = BUILD_DIR):
    """ctypes handle to the library built from ``native/<name>.c``, or None
    when it cannot be built or lacks ``symbol``."""
    log = logging.getLogger("smcsmc_tpu")
    try:
        lib = ctypes.CDLL(build(name, build_dir))
        getattr(lib, symbol)
    except (OSError, AttributeError, subprocess.CalledProcessError) as exc:
        log.warning("native %s unavailable (%s); using the Python path",
                    name, exc)
        return None
    return lib
