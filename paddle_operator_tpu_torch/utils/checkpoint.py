"""Checkpoint/resume for train-state trees: the single-process v2 format of
``paddle_operator_tpu/utils/checkpoint.py``, read and written by the port.

Format (v2): one directory per step, ``step_%012d``, holding ``state.npz``
(flat path -> array, the names of :func:`..bridge.flatten`) and
``manifest.json`` (step, tree structure, meta, per-leaf CRC32 checksums,
and a terminal COMMIT marker written after every array byte). A step is
published by renaming a temporary directory, so a reader never sees half
of one; on storage where rename is not atomic a torn write leaves an
unparseable or uncommitted manifest, which readers skip.
:func:`restore_latest` walks back past torn or checksum-failing steps,
quarantining each with a ``.corrupt`` rename. Tensors are stored in the
reference layout as numpy arrays, so the two packages read each other's
checkpoints. The sharded multi-host format is not ported.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import threading
import time
import zipfile
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .. import bridge

log = logging.getLogger("tpujob.checkpoint")

#: manifest format carrying checksums + the commit marker
FORMAT_VERSION = 2
#: terminal manifest key: a torn manifest either fails to parse or lacks it
COMMIT_MARKER = "COMMIT"


class CorruptCheckpointError(ValueError):
    """A step directory exists but cannot be trusted: manifest missing or
    torn, or a leaf failing its checksum."""


def _leaf_crc(arr: Any) -> int:
    """CRC32 over the leaf's raw bytes."""
    return zlib.crc32(np.ascontiguousarray(np.asarray(arr)).tobytes())


def _owned_host(x: Any) -> np.ndarray:
    """A host snapshot that owns its memory. The port updates its state in
    place, so a zero-copy view of a live tensor would change under the
    writer; every leaf is copied here."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, "step_%012d" % step)


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    meta: Optional[dict] = None, keep: int = 3) -> str:
    """Write ``state`` (torch or numpy leaves) atomically; prune to the
    newest ``keep`` steps."""
    arrays = {k: _owned_host(v) for k, v in bridge.flatten(state).items()}
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "state.npz"), **arrays)
        manifest = {
            "step": step,
            "structure": bridge.structure(state),
            "meta": meta or {},
            "format_version": FORMAT_VERSION,
            "checksums": {k: _leaf_crc(a) for k, a in arrays.items()},
            # terminal key: json keeps insertion order, so a torn write
            # truncates before the marker
            "commit": COMMIT_MARKER,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    log.info("checkpoint saved: %s", final)
    gc_checkpoints(ckpt_dir, keep_last_n=keep)
    return final


class AsyncCheckpointer:
    """Background-thread checkpoint writer: the train loop pays only the
    device-to-host snapshot; serialization, the atomic rename and pruning
    run off-thread.

    * one save in flight: a new :meth:`save` first waits for the previous
      write, so checkpoints land in order;
    * :meth:`wait` drains the pending write (call before exit);
    * a failed write re-raises on the NEXT save/wait.
    """

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()

    def save(self, ckpt_dir: str, step: int, state: Any,
             meta: Optional[dict] = None, keep: int = 3) -> None:
        self.wait()   # one in flight; raises a previous write's error
        # owned snapshot now: the loop goes on updating the state in place
        host_state = bridge.tree_map(_owned_host, state)

        def write() -> None:
            try:
                save_checkpoint(ckpt_dir, step, host_state, meta=meta,
                                keep=keep)
            except BaseException as e:  # surfaced on next save/wait
                with self._lock:
                    self._error = e

        self._thread = threading.Thread(
            target=write, name="ckpt-write-%d" % step, daemon=True)
        self._thread.start()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Drain the pending write; re-raise a failed write's exception."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    "checkpoint write %r still in flight after %.1fs"
                    % (self._thread.name, timeout))
            self._thread = None
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err


def _listed_steps(ckpt_dir: str,
                  names: Optional[List[str]] = None) -> List[int]:
    """Steps with a manifest.json present, without a validity check;
    ``.corrupt`` quarantines and foreign names are skipped."""
    if names is None:
        if not os.path.isdir(ckpt_dir):
            return []
        names = os.listdir(ckpt_dir)
    out = []
    for name in names:
        if not name.startswith("step_"):
            continue
        try:
            step = int(name[len("step_"):])
        except ValueError:
            continue
        if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(step)
    return sorted(out)


def _manifest_committed(manifest: dict) -> bool:
    """v2 manifests must carry the COMMIT marker; v1 manifests are trusted
    if structurally complete."""
    try:
        if int(manifest.get("format_version") or 1) >= FORMAT_VERSION:
            return manifest.get("commit") == COMMIT_MARKER
    except (TypeError, ValueError):
        return False
    return "step" in manifest and "structure" in manifest


def _load_manifest(ckpt_dir: str, step: int) -> dict:
    path = os.path.join(_step_dir(ckpt_dir, step), "manifest.json")
    try:
        with open(path) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise CorruptCheckpointError(
            "checkpoint step %d under %s has no manifest.json (torn write?)"
            % (step, ckpt_dir))
    except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
        raise CorruptCheckpointError(
            "checkpoint step %d under %s has an unreadable manifest (torn "
            "write?): %s" % (step, ckpt_dir, e))
    if not isinstance(manifest, dict) or not _manifest_committed(manifest):
        raise CorruptCheckpointError(
            "checkpoint step %d under %s is uncommitted (manifest lacks the "
            "%s marker)" % (step, ckpt_dir, COMMIT_MARKER))
    return manifest


def all_steps(ckpt_dir: str, names: Optional[List[str]] = None) -> List[int]:
    """Steps safe to restore from: manifest present, parseable and
    committed. A torn step is skipped with a warning."""
    out = []
    for step in _listed_steps(ckpt_dir, names):
        try:
            _load_manifest(ckpt_dir, step)
        except CorruptCheckpointError as e:
            log.warning("skipping unusable checkpoint step %d: %s", step, e)
            continue
        out.append(step)
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def quarantine_step(ckpt_dir: str, step: int) -> Optional[str]:
    """Rename a corrupt step directory to ``step_N.corrupt`` (numbered if
    taken). Returns the new path, or None if the directory vanished."""
    src = _step_dir(ckpt_dir, step)
    dst = src + ".corrupt"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = "%s.corrupt.%d" % (src, n)
    try:
        os.rename(src, dst)
    except OSError:
        return None
    log.warning("quarantined corrupt checkpoint step %d -> %s", step, dst)
    return dst


_gc_lock = threading.Lock()


def gc_checkpoints(ckpt_dir: str, keep_last_n: int = 3,
                   keep_corrupt: int = 2,
                   stale_grace_seconds: float = 3600.0) -> List[str]:
    """Keep the newest ``keep_last_n`` valid steps and at most
    ``keep_corrupt`` quarantined corpses; remove torn steps older than
    the newest valid one, and staging debris (``.tmp_*``, manifest-less
    step dirs) older than ``stale_grace_seconds``. Returns the paths
    removed."""
    removed: List[str] = []
    if not os.path.isdir(ckpt_dir):
        return removed
    with _gc_lock:
        try:
            names = sorted(os.listdir(ckpt_dir))
        except OSError:
            return removed
        listed = _listed_steps(ckpt_dir, names)
        steps = all_steps(ckpt_dir, names)
        doomed = steps[:-keep_last_n] if keep_last_n > 0 else []
        if steps:
            valid = set(steps)
            doomed += [s for s in listed if s not in valid and s < steps[-1]]
        for old in doomed:
            path = _step_dir(ckpt_dir, old)
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
        corpses = [n for n in names if n.startswith("step_")
                   and ".corrupt" in n]
        for name in corpses[:max(0, len(corpses) - keep_corrupt)]:
            path = os.path.join(ckpt_dir, name)
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
        now = time.time()
        for name in names:
            if name.startswith(".tmp_"):
                pass
            elif (name.startswith("step_") and ".corrupt" not in name
                    and name[len("step_"):].isdigit()
                    and not os.path.exists(
                        os.path.join(ckpt_dir, name, "manifest.json"))):
                pass   # a torn rename left a manifest-less step
            else:
                continue
            path = os.path.join(ckpt_dir, name)
            try:
                age = now - os.stat(path).st_mtime
            except OSError:
                continue
            if age >= stale_grace_seconds:
                shutil.rmtree(path, ignore_errors=True)
                removed.append(path)
    return removed


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       _manifest: Optional[dict] = None
                       ) -> Tuple[Any, dict]:
    """Load ``(state, manifest)``, the state as a tree of numpy arrays.
    Raises :class:`CorruptCheckpointError` on a torn manifest, an
    unreadable ``state.npz`` or a CRC32 mismatch (one attempt, no
    fallback: :func:`restore_latest` walks back)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError("no checkpoints under %s" % ckpt_dir)
    path = _step_dir(ckpt_dir, step)
    manifest = (_manifest if _manifest is not None
                else _load_manifest(ckpt_dir, step))
    if manifest.get("format") == "sharded":
        raise NotImplementedError(
            "checkpoint step %d is in the sharded multi-host format, which "
            "the port does not read yet" % step)
    try:
        with np.load(os.path.join(path, "state.npz")) as npz:
            flat = {k: npz[k] for k in npz.files}
    except FileNotFoundError:
        raise CorruptCheckpointError(
            "checkpoint step %d has no state.npz" % step)
    except (ValueError, OSError, KeyError, zipfile.BadZipFile,
            zlib.error) as e:
        raise CorruptCheckpointError(
            "checkpoint step %d has an unreadable state.npz: %s" % (step, e))
    for key, want in (manifest.get("checksums") or {}).items():
        if key not in flat:
            raise CorruptCheckpointError(
                "checkpoint step %d is missing leaf %r" % (step, key))
        if _leaf_crc(flat[key]) != int(want):
            raise CorruptCheckpointError(
                "checkpoint step %d leaf %r failed its CRC32 check (bit rot "
                "or torn write)" % (step, key))
    log.info("checkpoint restored: %s", path)
    return bridge.unflatten(manifest["structure"], flat), manifest


def restore_latest(ckpt_dir: str) -> Tuple[Any, dict]:
    """Restore the newest step that loads, walking newest -> oldest and
    quarantining every torn or checksum-corrupt step on the way. Raises
    FileNotFoundError when no valid step survives."""
    while True:
        steps = _listed_steps(ckpt_dir)
        if not steps:
            raise FileNotFoundError(
                "no restorable checkpoints under %s" % ckpt_dir)
        step = steps[-1]
        try:
            manifest = _load_manifest(ckpt_dir, step)
            return restore_checkpoint(ckpt_dir, step=step,
                                      _manifest=manifest)
        except CorruptCheckpointError as e:
            log.warning("checkpoint step %d is unusable (%s); falling back "
                        "to the previous step", step, e)
            if quarantine_step(ckpt_dir, step) is None \
                    and os.path.isdir(_step_dir(ckpt_dir, step)):
                raise


def load_into(state: Any, restored: Any) -> Any:
    """Copy a restored numpy tree into a live torch state tree in place,
    leaf by leaf; names, shapes and dtypes must match. Returns ``state``."""
    live = bridge.flatten(state)
    got = bridge.flatten(restored)
    if set(live) != set(got):
        raise ValueError("checkpoint leaves do not match the state: missing "
                         "%s, extra %s" % (sorted(set(live) - set(got))[:5],
                                           sorted(set(got) - set(live))[:5]))
    with torch.no_grad():
        for name, t in live.items():
            src = torch.from_numpy(np.asarray(got[name]))
            if tuple(src.shape) != tuple(t.shape) or src.dtype != t.dtype:
                raise ValueError(
                    "checkpoint leaf %r is %s %s, the state's is %s %s"
                    % (name, src.dtype, tuple(src.shape), t.dtype,
                       tuple(t.shape)))
            t.copy_(src)
    return state
