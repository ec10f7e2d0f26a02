"""The compile cache of the port: kernel libraries keyed by a toolchain-
and-device fingerprint and shared by a fleet through the artifact tier,
and the step cost kept for a restart. The port's counterpart of
``paddle_operator_tpu/compile_cache.py``.

PyTorch eager has no step executable to serialize: what the port
compiles is the ``nvcc`` libraries of ``csrc/``, one a source
(:mod:`.ops._kernels`). :func:`load_library` takes each down a ladder:

1. **memo**: the library is already loaded in this process;
2. **local**: ``<dir>/<name>-<fingerprint>.so`` in the cache directory
   (``TPUJOB_COMPILE_CACHE_DIR``, default the git-ignored
   ``build/kernels`` beside the package);
3. **fleet**: fetched from the artifact tier (:mod:`.artifacts`,
   ``TPUJOB_ARTIFACT_STORE`` / ``TPUJOB_ARTIFACT_URL``), verified by the
   store's digest check before it is written atomically into the local
   rung and loaded;
4. **built**: ``nvcc`` under a granted compile lease (a cold fleet builds
   each library once; peers wait, then fetch), then published.

The key (:func:`library_fingerprint`) hashes the source, ``NVCC_FLAGS``
and what :func:`toolchain_and_device` reads: ``nvcc --version``, the CUDA
driver's version, torch's and its CUDA's, and the device's name and
compute capability. An upgraded toolchain or another card never reuses a
library built for the old one. The first use of a library this process
did not build is checked as well: a missing symbol or a launch error
deletes it, counts it (``note_first_call_reject`` for a fetched one) and
rebuilds it from the same source. Nothing falls back to the plain
PyTorch version: the only way down from a bad library is ``nvcc``, and a
failed build raises.

The step-cost sidecar (:func:`load_step_cost`, :func:`save_step_cost`)
keeps a step's counted FLOPs under its :func:`step_fingerprint` in the
cache directory, so a restart's first step runs without the counter. It
persists only where ``TPUJOB_COMPILE_CACHE_DIR`` names the directory:
the default ``build/kernels`` is shared by every run of a checkout, and a
cost is the counter's reading of one run's kernel paths, not bytes that a
key can name whole.

``TPUJOB_COMPILE_CACHE=0`` turns the cache off: every process builds
into a private temporary directory and neither reuses nor publishes.
All mutable state lives in :class:`_CacheState` under its lock.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import itertools
import json
import logging
import os
import shutil
import subprocess
import tempfile
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from . import artifacts
from .ops import _kernels
from .parallel.mesh import Mesh

log = logging.getLogger("tpujob.compile_cache")

#: the ladder's rungs, cheapest first
RUNGS = ("memo", "local", "fleet", "built")
#: the bundle member that carries a library's bytes
LIBRARY_MEMBER = "lib"

_STAT_KEYS = ("memo_hits", "local_hits", "fleet_hits",
              "builds", "first_call_rejects", "step_cost_hits",
              "step_cost_misses", "step_cost_saves")


class _CacheState:
    """The ladder's mutable state under ONE lock: the memo of loaded
    libraries, the counters, each library's record and the private
    directory of a process whose cache is off or unwritable."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> KernelLibrary: at most one a source of csrc/
        self.memo: Dict[str, KernelLibrary] = {}
        self.stats: Dict[str, Any] = {}
        # name -> {"rung", "fingerprint", "compile_s", "fleet_s", "load_s",
        #          "rejected"}: what served each library in this process
        self.libraries: Dict[str, Dict[str, Any]] = {}
        # one ladder descent at a time per library name in this process
        self.name_locks: Dict[str, threading.Lock] = {}
        self.private_dir: Optional[str] = None
        self.warned_dirs: set = set()
        # builds in flight and when the first of them began: the ladder's
        # threads build at once, and compile_seconds counts wall time
        self.building = 0
        self.building_since = 0.0
        self.reset()

    def reset(self) -> None:
        self.memo.clear()
        self.libraries.clear()
        self.stats.update(dict.fromkeys(_STAT_KEYS, 0), compile_seconds=0.0)


_state = _CacheState()
_reload_counter = itertools.count()


def cache_enabled() -> bool:
    return os.environ.get("TPUJOB_COMPILE_CACHE", "1") != "0"


def memo_size() -> int:
    with _state._lock:
        return len(_state.memo)


def default_cache_dir() -> str:
    """``TPUJOB_COMPILE_CACHE_DIR``, else ``build/kernels`` beside the
    package (git-ignored), where ``python3 chip_smoke.py`` builds."""
    return os.environ.get("TPUJOB_COMPILE_CACHE_DIR", "") or str(
        _kernels.BUILD_DIR)


def _writable_dir(path: str) -> bool:
    """True iff ``path`` exists (or can be made), takes writes, and is
    OWNED by this user: a read-only cache volume degrades to private
    builds, and a foreign-owned directory is never trusted at all (a
    library in it is code this process would run)."""
    try:
        os.makedirs(path, mode=0o700, exist_ok=True)
        if hasattr(os, "getuid") and os.stat(path).st_uid != os.getuid():
            log.warning("compile cache dir %s is owned by uid %d, not us; "
                        "refusing to use it", path, os.stat(path).st_uid)
            return False
        # one name a call: the ladder's threads probe at once
        probe = os.path.join(path, ".wprobe.%d.%d" % (
            os.getpid(), next(_reload_counter)))
        with open(probe, "w") as fh:
            fh.write("ok")
        os.remove(probe)
        return True
    except OSError:
        return False


def _private_dir() -> str:
    """This process's own build directory (removed at exit): where a
    process whose cache is off, or whose cache directory is unusable,
    builds its libraries."""
    with _state._lock:
        if _state.private_dir is None:
            d = tempfile.mkdtemp(prefix="tpujob-kernels-")
            atexit.register(shutil.rmtree, d, True)
            _state.private_dir = d
        return _state.private_dir


def _shared_dir() -> Optional[str]:
    """The cache directory when the cache is on and the directory usable,
    else None (one warning a directory)."""
    if not cache_enabled():
        return None
    path = default_cache_dir()
    if _writable_dir(path):
        return path
    with _state._lock:
        first = path not in _state.warned_dirs
        _state.warned_dirs.add(path)
    if first:
        log.warning("compile cache dir %s not writable; building into a "
                    "private directory", path)
    return None


# ---------------------------------------------------------------------------
# the library fingerprint
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _nvcc_version() -> str:
    try:
        out = subprocess.run([_kernels.nvcc_path(), "--version"],
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout
    except (_kernels.KernelBuildError, OSError,
            subprocess.SubprocessError):
        return "absent"
    return " ".join(out.split())


@functools.lru_cache(maxsize=1)
def _driver_version() -> str:
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        v = ctypes.c_int(0)
        if lib.cuDriverGetVersion(ctypes.byref(v)) != 0:
            return "unreadable"
        return str(v.value)
    except (OSError, AttributeError):
        return "absent"


def toolchain_and_device() -> Dict[str, str]:
    """What a library's bytes depend on besides its source and flags:
    nvcc's version, the CUDA driver's, torch's and its CUDA's, and the
    current device's name and compute capability ("none" without a
    card). The one place the key reads the machine."""
    if torch.cuda.is_available():
        dev = torch.cuda.current_device()
        name = torch.cuda.get_device_name(dev)
        capability = "%d.%d" % torch.cuda.get_device_capability(dev)
    else:
        name = capability = "none"
    return {"nvcc": _nvcc_version(), "driver": _driver_version(),
            "torch": torch.__version__,
            "torch_cuda": str(torch.version.cuda),
            "device": name, "capability": capability}


def library_fingerprint(name: str) -> str:
    """The key of ``csrc/<name>.cu``'s library: a digest of the source,
    ``NVCC_FLAGS`` and every field of :func:`toolchain_and_device`."""
    src = hashlib.sha256(_kernels.source(name).read_bytes()).hexdigest()
    fields = toolchain_and_device()
    parts = ["name=%s" % name, "src=%s" % src,
             "flags=%s" % " ".join(_kernels.NVCC_FLAGS)]
    parts += ["%s=%s" % (k, fields[k]) for k in sorted(fields)]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:32]


# ---------------------------------------------------------------------------
# the library ladder
# ---------------------------------------------------------------------------

def _open_cdll(path: str) -> Any:
    """dlopen ``path``; raises OSError on a file that is no library."""
    return ctypes.CDLL(path)


def _open_fresh(path: str) -> Any:
    """dlopen a library written over one this process has already mapped:
    the loader matches an open library by its path, so map it through a
    link of a name never used before (the mapping outlives the link)."""
    alias = "%s.r%d.%d" % (path, os.getpid(), next(_reload_counter))
    os.link(path, alias)
    try:
        return _open_cdll(alias)
    finally:
        os.remove(alias)


def _atomic_write(path: str, payload: bytes) -> bool:
    """tmp + ``os.replace``: readers never see a torn file. False (never
    raises) on an unwritable target."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(tmp, "wb") as fh:
            fh.write(payload)
        os.replace(tmp, path)
        return True
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def _install(members: Optional[Dict[str, bytes]], path: str) -> bool:
    """Write a verified fetch's library member into the local rung."""
    payload = (members or {}).get(LIBRARY_MEMBER)
    return isinstance(payload, bytes) and _atomic_write(path, payload)


def _fleet_rung(store: Any, fingerprint: str, path: str,
                label: str) -> Tuple[Optional[str], Any]:
    """Fetch before compiling, under a compile-lease singleflight.

    Returns ``(tier, None)``: a verified library from ``tier`` now lies
    at ``path``; or ``(None, lease)``: this process is the fleet's one
    builder of the fingerprint and must release the lease; or ``(None,
    None)``: the bounded wait expired or the store is degraded, so build
    leaseless (duplicate work, never a wedge)."""
    members, tier = store.fetch(fingerprint)
    if _install(members, path):
        return tier, None
    deadline = time.monotonic() + store.wait_s
    while True:
        lease = store.acquire_compile_lease(fingerprint)
        if lease.granted:
            # re-fetch under the lease: a peer may have published and
            # released between our miss and this acquire (a publish
            # precedes its release)
            try:
                members, tier = store.fetch(fingerprint)
                if _install(members, path):
                    lease.release()
                    return tier, None
            except BaseException:
                # a raise between grant and hand-off must not strand the
                # fingerprint: peers would wait out the TTL
                lease.release()
                raise
            return None, lease
        log.info("compile lease for %s (%s) held by a peer; waiting then "
                 "fetching (bounded %.0fs)", label, fingerprint[:12],
                 store.wait_s)
        members, tier = store.wait_fetch(fingerprint, deadline)
        if members is not None:
            if _install(members, path):
                return tier, None
            return None, None  # a bundle without a library: build
        if time.monotonic() >= deadline:
            return None, None
        # the lease freed without a publish (its holder died mid-build):
        # loop and re-try the acquire; we may become the builder


class _FirstCall:
    """One symbol of a library on probation: ``argtypes`` / ``restype``
    pass through to the ctypes function; a non-zero return (every entry
    point of ``csrc/`` returns a CUDA error code) from the library's
    first use rejects it and calls the rebuilt library's symbol."""

    def __init__(self, lib: "KernelLibrary", sym: str, fn: Any) -> None:
        object.__setattr__(self, "_lib", lib)
        object.__setattr__(self, "_sym", sym)
        object.__setattr__(self, "_fn", fn)

    def __getattr__(self, attr: str) -> Any:
        return getattr(self._fn, attr)

    def __setattr__(self, attr: str, value: Any) -> None:
        setattr(self._fn, attr, value)

    def __call__(self, *args: Any) -> Any:
        err = self._fn(*args)
        if err == 0 or self._lib.verified:
            self._lib.verified = True
            return err
        fn = self._lib._reject_and_get(self._sym, "launch error %r" % err)
        fn.argtypes = self._fn.argtypes
        fn.restype = self._fn.restype
        return fn(*args)


class KernelLibrary:
    """A loaded library of ``csrc/<name>.cu``: ctypes attribute access to
    its symbols, plus where it came from (``rung``). A library this
    process built is trusted; one from the local or the fleet rung is on
    probation until a call of it returns 0. A missing symbol or a
    failed first call deletes it, counts it, rebuilds it from the same
    source and goes on with the rebuilt one."""

    def __init__(self, name: str, cdll: Any, rung: str, path: str,
                 fingerprint: str, tier: Optional[str] = None,
                 store: Any = None) -> None:
        self.name = name
        self.rung = rung
        self.path = path
        self.fingerprint = fingerprint
        self.verified = rung == "built"
        self._cdll = cdll
        self._tier = tier
        self._store = store

    def __getattr__(self, sym: str) -> Any:
        if sym.startswith("_"):
            raise AttributeError(sym)
        try:
            fn = getattr(self._cdll, sym)
        except AttributeError:
            if self.verified:
                raise
            return self._reject_and_get(sym, "missing symbol %s" % sym)
        return fn if self.verified else _FirstCall(self, sym, fn)

    def _reject_and_get(self, sym: str, why: str) -> Any:
        """Reject this library (once, under the name's lock), rebuild it
        from its source, and return ``sym`` of the rebuilt library."""
        with _name_lock(self.name):
            if not self.verified:
                log.warning("kernel library %s (%s, %s rung) failed its "
                            "first use (%s); rebuilding from source",
                            self.name, self.fingerprint[:12], self.rung, why)
                _remove(self.path)
                if self._store is not None and self.rung == "fleet":
                    self._store.note_first_call_reject(self._tier)
                with _state._lock:
                    _state.stats["first_call_rejects"] += 1
                    rec = _state.libraries.setdefault(self.name, {})
                    rec["rejected"] = why
                seconds = _build_one(self.name, self.path)
                self._cdll = _open_fresh(self.path)
                self.rung, self.verified = "built", True
                with _state._lock:
                    rec["rung"] = "built"
                    rec["compile_s"] = rec.get("compile_s", 0.0) + seconds
                _publish(self._store, self.fingerprint, self.path)
        return getattr(self._cdll, sym)


def _name_lock(name: str) -> threading.Lock:
    with _state._lock:
        return _state.name_locks.setdefault(name, threading.Lock())


def _build_one(name: str, path: str) -> float:
    """``nvcc`` for one library into ``path`` (the cold rung); raises
    :class:`.ops._kernels.KernelBuildError` on failure. Returns nvcc's
    seconds. The process's ``compile_seconds`` takes the wall time during
    which any build ran, so builds in parallel count once."""
    with _state._lock:
        if not _state.building:
            _state.building_since = time.perf_counter()
        _state.building += 1
    try:
        seconds = _kernels.build(name, path)
    finally:
        with _state._lock:
            _state.building -= 1
            if not _state.building:
                _state.stats["compile_seconds"] += (
                    time.perf_counter() - _state.building_since)
    with _state._lock:
        _state.stats["builds"] += 1
    return seconds


def _publish(store: Any, fingerprint: str, path: str) -> None:
    if store is None:
        return
    try:
        with open(path, "rb") as fh:
            payload = fh.read()
        store.publish(fingerprint, {LIBRARY_MEMBER: payload})
    except Exception as e:
        # best-effort by contract: a broken store costs a peer a build
        log.warning("fleet publish of %s failed: %s", fingerprint[:12], e)


def _open_checked(name: str, path: str, rung: str, fingerprint: str,
                  tier: Optional[str] = None,
                  store: Any = None) -> Optional[KernelLibrary]:
    """Open a library the ladder did not build; a file that is no library
    (a torn or foreign file) is deleted and reported as a miss."""
    if not os.path.exists(path):
        return None
    try:
        cdll = _open_cdll(path)
    except OSError as e:
        log.warning("discarding unloadable kernel library %s: %s", path, e)
        _remove(path)
        if store is not None and rung == "fleet":
            store.note_first_call_reject(tier)
        with _state._lock:
            _state.stats["first_call_rejects"] += 1
        return None
    return KernelLibrary(name, cdll, rung, path, fingerprint, tier, store)


def _descend(name: str) -> KernelLibrary:
    """The ladder below the memo for one library."""
    with _name_lock(name):
        with _state._lock:
            lib = _state.memo.get(name)
            if lib is not None:   # another thread loaded it meanwhile
                _state.stats["memo_hits"] += 1
                return lib
        fp = library_fingerprint(name)
        shared = _shared_dir()
        path = os.path.join(shared or _private_dir(),
                            "%s-%s.so" % (name, fp))
        rec: Dict[str, Any] = {"fingerprint": fp, "compile_s": 0.0,
                               "fleet_s": 0.0, "load_s": 0.0}
        lib = None
        if shared is not None:
            t0 = time.perf_counter()
            lib = _open_checked(name, path, "local", fp)
            rec["load_s"] = time.perf_counter() - t0
        store = artifacts.get_store() if cache_enabled() else None
        lease = None
        if lib is None and store is not None:
            t0 = time.perf_counter()
            tier, lease = _fleet_rung(store, fp, path, name)
            rec["fleet_s"] = time.perf_counter() - t0
            if tier is not None:
                t0 = time.perf_counter()
                lib = _open_checked(name, path, "fleet", fp, tier, store)
                rec["load_s"] = time.perf_counter() - t0
        if lib is None:
            # a granted lease must survive no exception past this point
            try:
                rec["compile_s"] = _build_one(name, path)
                lib = KernelLibrary(name, _open_cdll(path), "built", path,
                                    fp, store=store)
                _publish(store, fp, path)
            finally:
                if lease is not None:
                    lease.release()
        rec["rung"] = lib.rung
        with _state._lock:
            if lib.rung in ("local", "fleet"):
                _state.stats["%s_hits" % lib.rung] += 1
            _state.libraries[name] = rec
            _state.memo[name] = lib
        log.info("kernel library %s (%s) from the %s rung", name, fp[:12],
                 lib.rung)
        return lib


def load_library(name: str) -> KernelLibrary:
    """The library of ``csrc/<name>.cu`` down the ladder: memo, local,
    fleet, built. A library already loaded counts a memo hit."""
    with _state._lock:
        lib = _state.memo.get(name)
        if lib is not None:
            _state.stats["memo_hits"] += 1
            return lib
    return _descend(name)


def launch_library(name: str) -> KernelLibrary:
    """:func:`load_library` for a kernel's launch (``_kernels.load``): a
    launch is no cache lookup, so the memo counts no hit for it."""
    with _state._lock:
        lib = _state.memo.get(name)
    return lib if lib is not None else _descend(name)


def load_libraries(names: Iterable[str]) -> Dict[str, KernelLibrary]:
    """Several libraries down the ladder at once, one thread a library,
    so the builds a process is granted run their nvcc in parallel and a
    wait on a peer's build holds up no other library."""
    names = list(dict.fromkeys(names))
    if len(names) <= 1:
        return {n: load_library(n) for n in names}
    with ThreadPoolExecutor(max_workers=len(names),
                            thread_name_prefix="kernel-ladder") as pool:
        futures = {n: pool.submit(load_library, n) for n in names}
        return {n: f.result() for n, f in futures.items()}


def libraries() -> Dict[str, Dict[str, Any]]:
    """What served each library this process loaded: ``rung``,
    ``fingerprint``, ``compile_s`` (nvcc), ``fleet_s`` (the fleet rung,
    waiting on a peer's build included), ``load_s`` (open and dlopen),
    and ``rejected`` where a first use failed."""
    with _state._lock:
        return {n: dict(r) for n, r in _state.libraries.items()}


# ---------------------------------------------------------------------------
# the step fingerprint
# ---------------------------------------------------------------------------

def _describe_code(code) -> str:
    """Digest of a code object: bytecode + scalar constants (nested code
    objects recurse). Catches 'same qualname, edited body' collisions
    without ever repr-ing objects whose repr embeds a memory address."""
    h = hashlib.sha1(code.co_code)
    for const in code.co_consts:
        if isinstance(const, (str, bytes, int, float, bool, complex,
                              type(None))):
            h.update(repr(const).encode())
        elif hasattr(const, "co_code"):
            h.update(_describe_code(const).encode())
    return h.hexdigest()[:12]


def _describe_fn(fn: Callable, depth: int) -> str:
    """Function identity INCLUDING its closed-over hyper-parameters: two
    optimizers differing only in lr must not share a key. Closure cells
    are described recursively (scalars by value, tensors by shape and
    dtype, functions by code digest and their own closures). An object
    with no stable description falls back to its ``repr``, which may
    embed an address: an unstable key is a safe failure (a miss), never
    a collision."""
    if depth <= 0:
        return "fn:depth-capped"
    if isinstance(fn, functools.partial):
        return "partial(%s,args=[%s],kw={%s})" % (
            _describe_fn(fn.func, depth - 1),
            ",".join(_describe(a, depth - 1) for a in fn.args),
            ",".join("%s=%s" % (k, _describe(v, depth - 1))
                     for k, v in sorted(fn.keywords.items())))
    inner = getattr(fn, "__func__", fn)  # bound method -> function
    # a bound method's object is part of it: two recorders (or optimizers)
    # of other settings must not share a key
    bound = (";self=%s" % _describe(fn.__self__, depth - 1)
             if isinstance(fn, types.MethodType) else "")
    name = "%s.%s" % (getattr(inner, "__module__", "?"),
                      getattr(inner, "__qualname__",
                              getattr(inner, "__name__", "?")))
    code = getattr(inner, "__code__", None)
    code_d = _describe_code(code) if code is not None else "nocode"
    cells = getattr(inner, "__closure__", None) or ()
    closed = []
    for cell in cells:
        try:
            closed.append(_describe(cell.cell_contents, depth - 1))
        except ValueError:  # empty cell
            closed.append("emptycell")
    defaults = getattr(inner, "__defaults__", None) or ()
    return "fn:%s@%s(%s)(d=%s)%s" % (
        name, code_d, ",".join(closed),
        ",".join(_describe(d, depth - 1) for d in defaults), bound)


_FUNCTION_TYPES = (types.FunctionType, types.MethodType,
                   types.BuiltinFunctionType, functools.partial, type)


def _is_process_group(obj: Any) -> bool:
    pg = getattr(torch.distributed, "ProcessGroup", None)
    return pg is not None and isinstance(obj, pg)


def _describe_object(obj: Any, depth: int) -> str:
    """A plain object by its type and attributes (and its ``__call__``'s
    code, if callable): stable across instances of equal state."""
    cls = type(obj)
    call = getattr(cls, "__call__", None)
    code = getattr(call, "__code__", None)
    return "obj:%s.%s%s{%s}" % (
        cls.__module__, cls.__qualname__,
        "@" + _describe_code(code) if code is not None else "",
        ",".join("%s=%s" % (k, _describe(v, depth - 1))
                 for k, v in sorted(vars(obj).items())))


def _describe(obj: Any, depth: int = 8) -> str:
    """Stable, cross-process description of one fingerprint component.

    The reference's text for scalars, modules, containers and callables;
    tensors and arrays collapse to dtype and shape (never their values);
    a :class:`.parallel.mesh.Mesh` to its (axis, size) items, a process
    group to its size, sets to their sorted items, and a plain object to
    its type and attributes. ``id()`` of live objects never leaks in."""
    if depth <= 0:
        return "depth-capped"
    if obj is None:
        return "none"
    if isinstance(obj, (bool, int, float, str, bytes)):
        return "%s:%r" % (type(obj).__name__, obj)
    if isinstance(obj, types.ModuleType):
        # closures capture `torch`/`np`; the module NAME is the stable
        # identity (its repr embeds a filesystem path)
        return "mod:%s" % getattr(obj, "__name__", "?")
    if isinstance(obj, dict):
        return "{%s}" % ",".join(
            "%r=%s" % (k, _describe(obj[k], depth - 1))
            for k in sorted(obj, key=repr))
    if isinstance(obj, (list, tuple)):
        return "[%s]" % ",".join(_describe(x, depth - 1) for x in obj)
    if isinstance(obj, (set, frozenset)):
        return "set{%s}" % ",".join(sorted(_describe(x, depth - 1)
                                           for x in obj))
    if isinstance(obj, Mesh):
        return "mesh(%s)" % ",".join(
            "%s=%d" % (a, s) for a, s in obj.shape.items())
    if _is_process_group(obj):
        return "group(size=%d)" % obj.size()
    shape = getattr(obj, "shape", None)
    dtype = getattr(obj, "dtype", None)
    try:
        # array-LIKE means an iterable-of-ints shape: a module (np.shape
        # is a function) or a duck-typed object must not take this branch
        shape = tuple(int(d) for d in shape) if shape is not None else None
    except (TypeError, ValueError):
        shape = None
    if shape is not None and dtype is not None:
        return "%s%r" % (dtype, shape)
    if callable(obj) and (isinstance(obj, _FUNCTION_TYPES)
                          or not isinstance(getattr(obj, "__dict__", None),
                                            dict)):
        return _describe_fn(obj, depth)
    if isinstance(getattr(obj, "__dict__", None), dict):
        return _describe_object(obj, depth)
    return "%s:%r" % (type(obj).__name__, obj)


def _device_kind(example_args: Any) -> str:
    """The kind of device the example's first tensor lies on."""
    stack = [example_args]
    while stack:
        x = stack.pop(0)
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                return "cuda:%s" % torch.cuda.get_device_name(x.device)
            return x.device.type
        if isinstance(x, dict):
            stack.extend(x[k] for k in sorted(x, key=repr))
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return "none"


@functools.lru_cache(maxsize=1)
def _port_digest() -> str:
    """Digest of the port's Python sources: a function's description
    covers its own code and closure, not the code it calls (the model's
    layers), so an edited port never reads a cost saved by the old one."""
    h = hashlib.sha256()
    root = _kernels.PACKAGE_DIR
    for path in sorted(root.rglob("*.py")):
        h.update(str(path.relative_to(root)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


#: the port's switches read when a step runs, not when it is built: the
#: step's closure cannot show them, and each changes what the FLOP counter
#: sees (the MoE kernels report no FLOPs, the dense einsums do)
RUN_TIME_SWITCHES = ("TPUJOB_MOE_FUSED",)
#: the launchers the kernels' wrappers call through their module's globals
#: (module under ``ops``, attribute): a launcher put in another's place,
#: such as a plain version in a kernel's, is another step
KERNEL_LAUNCHERS = (
    ("moe", "_launch_dispatch"), ("moe", "_launch_combine"),
    ("moe", "_Dispatch.forward"), ("moe", "_Dispatch.backward"),
    ("moe", "_Combine.forward"), ("moe", "_Combine.backward"),
    ("attention", "_launch_fwd"), ("attention", "_launch_dq"),
    ("attention", "_launch_dkv"), ("attention", "_launch"),
    ("optim", "_launch"))


def kernel_paths() -> str:
    """What a step's kernels do that neither its closure nor its shapes
    show: the value of each of RUN_TIME_SWITCHES and the description of
    each of KERNEL_LAUNCHERS as they stand now."""
    import importlib

    parts = ["%s=%s" % (k, os.environ.get(k, "")) for k in RUN_TIME_SWITCHES]
    for module, attr in KERNEL_LAUNCHERS:
        obj: Any = importlib.import_module(".ops." + module, __package__)
        for name in attr.split("."):
            obj = getattr(obj, name)
        parts.append("%s.%s=%s" % (module, attr, _describe(obj)))
    return ";".join(parts)


def step_fingerprint(fn: Callable, example_args: Tuple,
                     config: Any = None, mesh: Any = None) -> str:
    """Key of one step function: torch's version, the port's sources, the
    device kind, the world size and rank, the function's identity with its
    closed-over hyper-parameters (a bound method's object too), the
    kernel paths it runs now (:func:`kernel_paths`), the example args'
    structure, dtypes and shapes (data, not config: their values never
    enter), ``config`` (what the function depends on that its closure
    cannot show, such as the steps a call) and the mesh's shape."""
    dist = torch.distributed
    joined = dist.is_available() and dist.is_initialized()
    parts = [
        "torch=%s" % torch.__version__,
        "port=%s" % _port_digest(),
        "device=%s" % _device_kind(example_args),
        "world=%d" % (dist.get_world_size() if joined else 1),
        # a pipeline's stages can hold equal shapes and do unequal work
        "rank=%d" % (dist.get_rank() if joined else 0),
        _describe(fn),
        "kernels=%s" % kernel_paths(),
        "args=%s" % _describe(example_args),
        "config=%s" % _describe(config),
        "mesh=%s" % _describe(mesh),
    ]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:32]


# ---------------------------------------------------------------------------
# the step-cost sidecar
# ---------------------------------------------------------------------------

def _cost_path(fingerprint: str) -> Optional[str]:
    """The sidecar of a fingerprinted step's cost in the cache directory;
    None unless ``TPUJOB_COMPILE_CACHE_DIR`` is set, and with the cache
    off or unusable."""
    if not fingerprint or not os.environ.get("TPUJOB_COMPILE_CACHE_DIR"):
        return None
    d = _shared_dir()
    return os.path.join(d, "step-%s.cost.json" % fingerprint) if d else None


def _bump(key: str) -> None:
    with _state._lock:
        _state.stats[key] += 1


def load_step_cost(fingerprint: str) -> Optional[Dict[str, Any]]:
    """Persisted ``{"flops", "bytes", "source"}`` for a fingerprinted
    step: a restart must not pay a counted step just to learn its own
    FLOPs. None on a miss, never raises; a torn or malformed sidecar is
    DELETED as a miss with one warning (the next count re-saves it).

    Unlike the reference's, the sidecar stays in the cache directory and
    never rides the artifact tier: a cost bundle a step would be a
    publish of its own beside a MOVE's state bundle, and the restart it
    serves finds its own directory."""
    path = _cost_path(fingerprint)
    if not path:
        return None
    try:
        with open(path) as fh:
            raw = json.load(fh)
    except OSError:
        _bump("step_cost_misses")
        return None
    except ValueError:
        log.warning("discarding corrupt step-cost sidecar %s (torn "
                    "write?); the next count re-saves it", path)
        _remove(path)
        _bump("step_cost_misses")
        return None
    if not isinstance(raw, dict):
        log.warning("discarding malformed step-cost sidecar %s (expected "
                    "an object, got %s)", path, type(raw).__name__)
        _remove(path)
        _bump("step_cost_misses")
        return None
    _bump("step_cost_hits")
    return raw


def save_step_cost(fingerprint: str, cost: Dict[str, Any]) -> None:
    """Persist a counted step cost beside the libraries (tmp + replace:
    a reader never sees a torn file). Never raises: an unserializable
    cost or a full disk costs one re-count, not the run."""
    path = _cost_path(fingerprint)
    if not path:
        return
    try:
        payload = json.dumps(cost).encode()
    except (TypeError, ValueError) as e:
        log.warning("step cost for %s not JSON-serializable (%s); not "
                    "persisted", fingerprint[:12], e)
        return
    if _atomic_write(path, payload):
        _bump("step_cost_saves")


# ---------------------------------------------------------------------------
# stats / observability
# ---------------------------------------------------------------------------

def stats() -> Dict[str, Any]:
    with _state._lock:
        return dict(_state.stats)


def reset_stats_for_tests() -> None:
    with _state._lock:
        _state.reset()
        _state.warned_dirs.clear()


def _rung_of(libs: Dict[str, Dict[str, Any]]) -> str:
    """The most expensive rung that served one of this process's
    libraries (``none`` before any was loaded)."""
    got = {r.get("rung") for r in libs.values()}
    for rung in reversed(RUNGS):
        if rung in got:
            return rung
    with _state._lock:
        return "memo" if _state.stats["memo_hits"] else "none"


def startup_block() -> Dict[str, Any]:
    """The summary the runner embeds as ``result["compile_cache"]``:
    which rung served this process's libraries (``cache``: memo | local |
    fleet | built), the counters, each library's record and the artifact
    store's block."""
    s = stats()
    libs = libraries()
    return {
        "cache": _rung_of(libs),
        "dir": default_cache_dir() if cache_enabled() else "",
        "memo_hits": s["memo_hits"],
        "local_hits": s["local_hits"],
        "fleet_hits": s["fleet_hits"],
        "builds": s["builds"],
        "first_call_rejects": s["first_call_rejects"],
        "step_cost_hits": s["step_cost_hits"],
        "step_cost_misses": s["step_cost_misses"],
        "step_cost_saves": s["step_cost_saves"],
        "compile_seconds": round(s["compile_seconds"], 6),
        "libraries": libs,
        "artifacts": artifacts.stats_block(),
    }


def metrics_text() -> str:
    """Prometheus exposition of the ladder: hits by layer, builds and
    first-use rejects, the step-cost rung, the seconds in nvcc."""
    s = stats()
    lines = [
        "# HELP tpujob_compile_cache_hits_total compile cache hits by "
        "layer (in-process memo, local library, fleet library, step cost)",
        "# TYPE tpujob_compile_cache_hits_total counter",
    ]
    lines += ['tpujob_compile_cache_hits_total{layer="%s"} %d' % (layer, n)
              for layer, n in (("memo", s["memo_hits"]),
                               ("local", s["local_hits"]),
                               ("fleet", s["fleet_hits"]),
                               ("step_cost", s["step_cost_hits"]))]
    lines += [
        "# HELP tpujob_compile_cache_misses_total compile cache misses by "
        "layer (a library built here, a step cost counted here)",
        "# TYPE tpujob_compile_cache_misses_total counter",
        'tpujob_compile_cache_misses_total{layer="library"} %d'
        % s["builds"],
        'tpujob_compile_cache_misses_total{layer="step_cost"} %d'
        % s["step_cost_misses"],
        "# HELP tpujob_compile_cache_rejects_total fetched or local "
        "libraries that failed their first use and were rebuilt",
        "# TYPE tpujob_compile_cache_rejects_total counter",
        "tpujob_compile_cache_rejects_total %d" % s["first_call_rejects"],
        "# HELP tpujob_compile_seconds total wall seconds spent in nvcc "
        "in this process",
        "# TYPE tpujob_compile_seconds gauge",
        "tpujob_compile_seconds %.3f" % s["compile_seconds"],
    ]
    return "\n".join(lines) + "\n"


__all__ = [
    "KERNEL_LAUNCHERS", "KernelLibrary", "RUNGS", "RUN_TIME_SWITCHES",
    "cache_enabled", "default_cache_dir", "kernel_paths", "launch_library",
    "libraries", "library_fingerprint", "load_libraries", "load_library",
    "load_step_cost", "memo_size", "metrics_text",
    "reset_stats_for_tests", "save_step_cost", "startup_block", "stats",
    "step_fingerprint", "toolchain_and_device",
]
