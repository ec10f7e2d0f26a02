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
checkpoints.

Sharded format (:func:`save_checkpoint_sharded`, the multi-process one):
``step_N/<path>.sNN.npy`` per shard, ``shards.json`` indexing each
shard's slices of the global array with its CRC32, and the manifest
(``"format": "sharded"``). The port's states are replicated over ``dp``,
so each leaf is one shard, written by rank 0 (replica 0); every rank
writes its part of the index, and rank 0 merges them and publishes the
step, between the reference's four barriers. Readers assemble any tiling
the JAX package wrote (:func:`restore_checkpoint`).
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
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import bridge
from ..parallel import collectives

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
    * :meth:`wait` drains the pending write (call before exit or an
      elastic restart);
    * a failed write re-raises on the NEXT save/wait;
    * a second save of the step last accepted in the same directory is a
      no-op (an elastic restart re-enters the boundary it saved at), until
      a failed write or :meth:`sync_dedup` clears the marker.
    """

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        # (dir, step) of the last accepted save
        self._last_accepted: Optional[Tuple[str, int]] = None

    def save(self, ckpt_dir: str, step: int, state: Any,
             meta: Optional[dict] = None, keep: int = 3) -> None:
        # drain first: a failed write clears the marker, so its retry of
        # the same step is a real save
        self.wait()   # one in flight; raises a previous write's error
        if self._last_accepted == (ckpt_dir, step):
            log.info("checkpoint step %d already saved; skipped", step)
            return
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
        # set last: a save that raised above left nothing to skip
        self._last_accepted = (ckpt_dir, step)

    def sync_dedup(self, ckpt_dir: str, restored_step: int) -> None:
        """After a cycle's restore: the marker stays only if it names the
        step the restore landed on. A fallback below it (the marked step
        was quarantined as corrupt) means training will reach that
        boundary again, and its save must be real."""
        if (self._last_accepted is not None
                and self._last_accepted != (ckpt_dir, restored_step)):
            self._last_accepted = None

    def wait(self, timeout: Optional[float] = None) -> None:
        """Drain the pending write; re-raise a failed write's exception
        (clearing the duplicate-save marker: the step never landed)."""
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
            self._last_accepted = None
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
            if name.startswith(".tmp_") or name.startswith(".partial_step_"):
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
        return restore_checkpoint_sharded(ckpt_dir, step=step,
                                          _manifest=manifest)
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


def save_checkpoint_sharded(ckpt_dir: str, step: int, state: Any,
                            meta: Optional[dict] = None, keep: int = 3,
                            group: collectives.Group = None) -> str:
    """Write ``state``, replicated on every rank of ``group`` (``None``:
    one process), in the sharded format: rank 0 writes each leaf as one
    full-extent shard ``<path>.s0.npy``, every rank writes its index part,
    rank 0 merges the parts, writes ``shards.json`` and the manifest in
    the staging directory and renames it into place. Every rank calls
    this at the same step; barriers as the reference's (staging clean,
    shards written, index parts written, step published)."""
    rank = dist.get_rank(group) if group is not None else 0
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    # hidden from all_steps (no "step_" prefix); wiped before use so a
    # crashed prior attempt cannot leak stale shards into this one
    staging = os.path.join(ckpt_dir, ".partial_step_%012d" % step)
    if rank == 0 and os.path.exists(staging):
        shutil.rmtree(staging)
    collectives.barrier(group)
    os.makedirs(staging, exist_ok=True)

    index: Dict[str, Any] = {}
    for path, leaf in bridge.flatten(state).items():
        shape = tuple(leaf.shape)
        dtype = str(torch.empty(0, dtype=leaf.dtype).numpy().dtype
                    if isinstance(leaf, torch.Tensor) else leaf.dtype)
        entries = []
        if rank == 0:
            host = _owned_host(leaf)
            fname = "%s.s0.npy" % path.replace("/", "__")
            np.save(os.path.join(staging, fname), host)
            entries.append({"file": fname,
                            "slices": [[0, dim] for dim in shape],
                            "crc32": _leaf_crc(host)})
        index[path] = {"shape": list(shape), "dtype": dtype,
                       "shards": entries}

    if group is not None:
        collectives.barrier(group)
        part = os.path.join(staging, "index.p%d.json" % rank)
        with open(part, "w") as f:
            json.dump(index, f)
        collectives.barrier(group)
        if rank == 0:
            merged: Dict[str, Any] = {}
            for pi in range(dist.get_world_size(group)):
                part = os.path.join(staging, "index.p%d.json" % pi)
                with open(part) as f:  # a missing part is a hard error
                    data = json.load(f)
                for k, v in data.items():
                    if k in merged:
                        merged[k]["shards"].extend(v["shards"])
                    else:
                        merged[k] = v
                os.remove(part)
            index = merged

    if rank == 0:
        for entry in index.values():
            _check_coverage(entry)
        with open(os.path.join(staging, "shards.json"), "w") as f:
            json.dump(index, f)
        with open(os.path.join(staging, "manifest.json"), "w") as f:
            json.dump({"step": step, "structure": bridge.structure(state),
                       "meta": meta or {}, "format": "sharded",
                       "format_version": FORMAT_VERSION,
                       "commit": COMMIT_MARKER}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(staging, final)
        log.info("sharded checkpoint saved: %s", final)
        gc_checkpoints(ckpt_dir, keep_last_n=keep)
    # publish barrier: no rank lists the directory while rank 0 renames
    # and prunes, so every rank restores the same step
    collectives.barrier(group)
    return final


def _check_coverage(entry: Dict[str, Any]) -> None:
    """The shards must tile the whole array (distinct replica-0 shards are
    disjoint): a lost index part fails here, not as zeros at restore."""
    total = int(np.prod(entry["shape"], dtype=np.int64))
    covered = 0
    for shard in entry["shards"]:
        if shard["slices"] is None:
            covered += total
            continue
        covered += int(np.prod([b - a for a, b in shard["slices"]],
                               dtype=np.int64))
    if covered != total:
        raise CorruptCheckpointError(
            "sharded checkpoint coverage mismatch: %d/%d elements "
            "(lost shards or overlapping tiles)" % (covered, total))


def _load_shard(path: str, dtype_str: str, crc: Optional[int]) -> np.ndarray:
    want = np.dtype(dtype_str)
    try:
        data = np.load(path)
    except FileNotFoundError:
        raise CorruptCheckpointError("checkpoint shard %s is missing" % path)
    except (ValueError, OSError) as e:
        raise CorruptCheckpointError(
            "checkpoint shard %s is unreadable: %s" % (path, e))
    if crc is not None and _leaf_crc(data) != crc:
        raise CorruptCheckpointError(
            "checkpoint shard %s failed its CRC32 check (bit rot or torn "
            "write)" % path)
    return data if data.dtype == want else data.view(want)


def restore_checkpoint_sharded(ckpt_dir: str, step: Optional[int] = None,
                               _manifest: Optional[dict] = None
                               ) -> Tuple[Any, dict]:
    """Load a sharded step as ``(state, manifest)``, each leaf assembled
    on the host from its shards (whatever tiling wrote them: the port's
    one shard a leaf, or the JAX package's per-device tiles)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError("no checkpoints under %s" % ckpt_dir)
    path = _step_dir(ckpt_dir, step)
    manifest = (_manifest if _manifest is not None
                else _load_manifest(ckpt_dir, step))
    if manifest.get("format") != "sharded":
        raise ValueError("checkpoint at step %d is not sharded format" % step)
    try:
        with open(os.path.join(path, "shards.json")) as f:
            index = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError, UnicodeDecodeError,
            OSError) as e:
        raise CorruptCheckpointError(
            "sharded checkpoint step %d has no usable shards.json: %s"
            % (step, e))
    flat = {}
    for key, entry in index.items():
        _check_coverage(entry)
        out = np.zeros(tuple(entry["shape"]), np.dtype(entry["dtype"]))
        for shard in entry["shards"]:
            data = _load_shard(os.path.join(path, shard["file"]),
                               entry["dtype"], shard.get("crc32"))
            if shard["slices"] is None:
                out = data
                break
            out[tuple(slice(a, b) for a, b in shard["slices"])] = data
        flat[key] = out
    log.info("sharded checkpoint restored: %s", path)
    return bridge.unflatten(manifest["structure"], flat), manifest


def restore_latest(ckpt_dir: str,
                   group: collectives.Group = None) -> Tuple[Any, dict]:
    """Restore the newest step that loads, walking newest -> oldest and
    quarantining every torn or checksum-corrupt step on the way. Raises
    FileNotFoundError when no valid step survives.

    With a ``group`` of several ranks, every round is agreed: the step
    tried is the oldest of the ranks' newest, it counts only if every
    rank loaded it, and a quarantine is seen by every rank before the
    next round lists the directory, so the ranks never resume from
    different steps."""
    multi = group is not None and dist.get_world_size(group) > 1
    while True:
        steps = _listed_steps(ckpt_dir)
        step = steps[-1] if steps else -1
        if multi:
            step = collectives.min_int(step, group)
        if step < 0:
            raise FileNotFoundError(
                "no restorable checkpoints under %s" % ckpt_dir)
        result = None
        failure: Optional[CorruptCheckpointError] = None
        try:
            manifest = _load_manifest(ckpt_dir, step)
            result = restore_checkpoint(ckpt_dir, step=step,
                                        _manifest=manifest)
        except CorruptCheckpointError as e:
            failure = e
        ok = failure is None
        if multi:
            ok = bool(collectives.min_int(int(ok), group))
        if ok:
            return result
        log.warning("checkpoint step %d is unusable (%s); falling back "
                    "to the previous step", step,
                    failure if failure is not None
                    else "a peer process saw corruption")
        if quarantine_step(ckpt_dir, step) is None \
                and os.path.isdir(_step_dir(ckpt_dir, step)):
            raise failure if failure is not None else \
                CorruptCheckpointError(
                    "step %d failed on a peer process and could not be "
                    "quarantined" % step)
        if multi:
            # the rename is seen by every rank before the next listing
            collectives.barrier(group)


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
