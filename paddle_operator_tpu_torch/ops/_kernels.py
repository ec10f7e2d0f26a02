"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``.
The build happens at first use, never at import: importing the port needs
no ``nvcc`` and no GPU. Libraries are keyed by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.

A missing ``nvcc`` or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
#: build output, beside the package (``build/`` is git-ignored)
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: seconds this process has spent in nvcc (the runner charges what a run
#: spent building to its ``compile`` badput)
build_seconds = 0.0
_clock_lock = threading.Lock()


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


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / ("%s-%s.so" % (name, digest[:16]))


def _start_build(name: str) -> "tuple[Path, Path, subprocess.Popen]":
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".so.tmp%d" % os.getpid())
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build(names: Iterable[str]) -> List[Path]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns the library paths."""
    global build_seconds
    names = list(names)
    t0 = time.perf_counter()
    started = []
    for name in names:
        if not library_path(name).exists():
            started.append((name, *_start_build(name)))
    failures = []
    for name, out, tmp, proc in started:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append("%s (nvcc exit %d):\n%s"
                            % (name, proc.returncode, log))
        else:
            os.replace(tmp, out)   # atomic: a reader never sees half a file
    if started:
        with _clock_lock:
            build_seconds += time.perf_counter() - t0
    if failures:
        raise KernelBuildError("kernel build failed: " + "\n".join(failures))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, = build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
