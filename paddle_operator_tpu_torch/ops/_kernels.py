"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``.
The build happens at first use, never at import: importing the port needs
no ``nvcc`` and no GPU. :func:`load` takes a library down the compile
cache's ladder (:mod:`..compile_cache`: memo, local, fleet, built), which
keys it by its source, the flags, the toolchain and the device;
:func:`build` is the ladder's cold rung, one nvcc a library (the
ladder runs a process's builds in threads, so they run together).

A missing ``nvcc`` or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Union

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
#: the compile cache's default directory, beside the package (``build/``
#: is git-ignored)
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelBuildError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of "
        "paddle_operator_tpu_torch are built from csrc/ at first use")


def source(name: str) -> Path:
    src = CSRC_DIR / (name + ".cu")
    if not src.exists():
        raise KernelBuildError("no kernel source %s" % src)
    return src


def build(name: str, out: Union[str, Path]) -> float:
    """Compile ``csrc/<name>.cu`` into ``out`` (the compile cache's cold
    rung): one nvcc into a temporary beside it, moved over it atomically,
    so a reader never sees half a file. Returns nvcc's seconds; raises
    :class:`KernelBuildError` if nvcc is missing or refuses the source."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".tmp%d" % os.getpid())
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(source(name))],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError("kernel build failed: %s (nvcc exit %d):\n%s"
                               % (name, proc.returncode, proc.stdout))
    os.replace(tmp, out)
    return seconds


def load(name: str):
    """The loaded library of ``csrc/<name>.cu``
    (:class:`..compile_cache.KernelLibrary`) for a launch, down the
    compile cache's ladder on first use."""
    from .. import compile_cache

    return compile_cache.launch_library(name)
