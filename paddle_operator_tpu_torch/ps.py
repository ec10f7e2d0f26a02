"""Parameter-server training mode: the port of ``paddle_operator_tpu/ps.py``.

The operator wires PS mode: it renders ``TRAINING_ROLE``,
``PADDLE_PSERVERS_IP_PORT_LIST`` and ``PADDLE_TRAINERS_NUM`` into the ps
and worker pods and releases the pservers before the trainers. Every pod
runs the same script (``examples/train_wide_deep_ps.py``), and
:func:`run_ps_training` dispatches on the role:

* a **pserver** (``TRAINING_ROLE=PSERVER``) owns a contiguous shard of
  the flattened fp32 parameter vector and its momentum, and optionally a
  row shard of a sparse embedding table, in numpy on the host, behind a
  small HTTP protocol (:class:`ParamServer`). It places nothing on any
  device and never touches CUDA: a pserver pod need not have a card.
  Updates are bulk-synchronous (BSP): a round's update applies when every
  trainer's gradient for that version has arrived, then the version
  advances and blocked pulls release, so a PS run computes what
  synchronous data-parallel SGD computes.
* a **trainer** (``TRAINING_ROLE=TRAINER``) computes the forward and
  backward with torch autograd on CUDA (unless its job says
  ``device="cpu"``), pushes its gradient for every shard, then long-polls
  the next version. With ``embed_dim > 0`` it pulls and pushes only the
  embedding rows its batch touches (:func:`_train_sparse`).

The host half (:func:`shard_ranges`, :class:`SparseTable`,
:class:`SnapshotStore`, :func:`_pack_sparse` / :func:`_unpack_sparse`,
:class:`ParamServer`, :class:`PsClient`) is this package's own copy of the
reference's numpy code, and speaks its wire format byte for byte: the
paths, ``X-Version``, raw little-endian fp32 bodies, ``n|ids|rows`` sparse
pushes, the 409 on a stale push and the duplicate-push ack. A JAX trainer
and a port trainer can share one fleet of pservers, and snapshots load on
either side.

The trainer half keeps the reference's contracts:

* the flat vector lists the leaves in the JAX package's order, sorted
  dict keys and then list order (:func:`.bridge.flatten`), not dict
  insertion order: the servers' shard ranges are offsets into it;
* the parameters start from ``torch.Generator(device).manual_seed(
  job.seed)`` on every trainer (the first ``/init`` wins, and they agree);
* trainer ``w``'s batch of step ``s`` is ``job.make_batch(g, s)`` with
  ``g = data.step_generator(1000 + w, s, device)``, where the reference
  folds ``s`` into ``PRNGKey(1000 + w)``;
* the sparse mode does not pad the pulled rows to a power of two: the
  reference pads only so that ``jax.jit`` compiles once a bucket, the pad
  rows are zeros no id reads, and their gradients are dropped before the
  push, so the pushed rows and the numbers are the same without it.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import bridge
from .data import step_generator
from .device import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# flat-vector <-> param-tree plumbing (trainers only; the servers see only
# fp32 ranges)
# ---------------------------------------------------------------------------

def _flat_vector(leaves: List[torch.Tensor]) -> np.ndarray:
    """The leaves raveled into one host fp32 vector, gathered on their
    device and copied once."""
    return torch.cat([leaf.detach().reshape(-1).to(torch.float32)
                      for leaf in leaves]).cpu().numpy()


def flatten_params(params) -> Tuple[np.ndarray, Any, List]:
    """Params tree -> (flat fp32 vector, structure, leaf shapes), the
    leaves in the JAX package's order (:func:`.bridge.flatten`: sorted
    dict keys, then list order), so the vector is the one
    ``paddle_operator_tpu.ps.flatten_params`` gives for the same tree."""
    leaves = [leaf if isinstance(leaf, torch.Tensor)
              else torch.from_numpy(np.asarray(leaf))
              for leaf in bridge.leaves(params)]
    shapes = [(tuple(leaf.shape), leaf.dtype) for leaf in leaves]
    return _flat_vector(leaves), bridge.structure(params), shapes


def unflatten_params(vec: np.ndarray, treedef, shapes,
                     device: DeviceLike = None):
    """The tree of :func:`flatten_params` from a flat vector, as torch
    tensors on ``device`` (``None`` means CUDA): one copy of the vector to
    the device, then a view a leaf."""
    dev = resolve_device(device, "ps.unflatten_params")
    flat = torch.from_numpy(np.array(vec, np.float32, copy=True)).to(dev)
    # bridge.flatten of the structure lists its (None) leaves by path,
    # in the vector's order
    names = list(bridge.flatten(treedef))
    leaves, off = {}, 0
    for name, (shape, dtype) in zip(names, shapes):
        n = int(np.prod(shape)) if shape else 1
        leaves[name] = flat[off:off + n].reshape(shape).to(dtype)
        off += n
    return bridge.unflatten(treedef, leaves)


def shard_ranges(dim: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous near-equal [start, stop) ranges covering [0, dim)."""
    base, rem = divmod(dim, n_shards)
    out, start = [], 0
    for i in range(n_shards):
        stop = start + base + (1 if i < rem else 0)
        out.append((start, stop))
        start = stop
    return out


# ---------------------------------------------------------------------------
# sparse embedding shard (server side)
# ---------------------------------------------------------------------------

class SparseTable:
    """Row-sharded embedding shard with lazy init and per-row momentum.

    Rows materialize on first touch from a deterministic per-row RNG
    (seeded by (seed, row_id)), so every run — and a restarted pserver fed
    the same seed — agrees on untouched-row values without any dense init
    transfer. Optimizer state (momentum) is also per-row and lazy: memory
    on the server scales with TOUCHED rows, mirroring the wire traffic.

    Not thread-safe by itself: the owning ParamServer serializes access
    under its condition lock, which also carries the BSP version.
    """

    def __init__(self, dim: int, seed: int = 0, init_scale: float = 0.01):
        self.dim = dim
        self.seed = seed
        self.init_scale = init_scale
        self.rows: Dict[int, np.ndarray] = {}
        self.slots: Dict[int, np.ndarray] = {}

    def row(self, rid: int) -> np.ndarray:
        r = self.rows.get(rid)
        if r is None:
            rng = np.random.default_rng((self.seed, rid))
            r = (rng.standard_normal(self.dim) * self.init_scale).astype(
                np.float32)
            self.rows[rid] = r
        return r

    def gather(self, ids: np.ndarray) -> np.ndarray:
        if len(ids) == 0:
            return np.zeros((0, self.dim), np.float32)
        return np.stack([self.row(int(i)) for i in ids])

    def apply(self, grads_by_worker: List[Tuple[np.ndarray, np.ndarray]],
              lr: float, momentum: float,
              n_trainers: int) -> List[int]:
        """SGD+momentum on exactly the touched rows. Row gradient = sum of
        per-trainer gradients / n_trainers — identical semantics to the
        dense vector's mean-across-trainers (a trainer whose batch misses
        a row contributes an implicit zero), so a sparse PS run stays
        checkable against a single-process dense run. Returns the touched
        row ids (the snapshot delta)."""
        acc: Dict[int, np.ndarray] = {}
        for ids, grads in grads_by_worker:
            for i, rid in enumerate(ids):
                rid = int(rid)
                g = acc.get(rid)
                acc[rid] = grads[i].copy() if g is None else g + grads[i]
        for rid, gsum in acc.items():
            g = gsum / float(n_trainers)
            slot = self.slots.get(rid)
            slot = g if slot is None else momentum * slot + g
            self.slots[rid] = slot
            self.rows[rid] = self.row(rid) - lr * slot
        return list(acc.keys())


# ---------------------------------------------------------------------------
# pserver snapshot store (fault tolerance)
# ---------------------------------------------------------------------------

class SnapshotStore:
    """Atomic on-disk state for one pserver shard.

    Layout under ``snapshot_dir``:
      dense.npz                 {vec, slot, version}     (rewritten per apply)
      sparse_base.npz           {ids, rows, slots, version}
      sparse_delta_%012d.npz    {ids, rows, slots}       (one per apply)

    Every write goes tmp + ``os.replace`` so a crash mid-write leaves the
    previous state intact. Deltas replay in version order on restore and
    compact into the base every ``compact_every`` rounds.
    """

    def __init__(self, path: str, compact_every: int = 50):
        self.path = path
        self.compact_every = compact_every
        # serializes file operations between delta writes and the
        # BACKGROUND compaction thread — never held together with the
        # ParamServer condition lock, so no deadlock is possible
        self._lock = threading.Lock()
        # single-flight compaction (opslint OPS201/OPS202: the thread is
        # named, tracked, and joined in close(); previously every 50th
        # delta spawned an anonymous unjoined thread, so a slow disk
        # could stack concurrent compactions racing each other's
        # delta-removal pass)
        self._compact_thread: Optional[threading.Thread] = None
        os.makedirs(path, exist_ok=True)

    def _write(self, name: str, **arrays) -> None:
        # tmp keeps the .npz suffix so np.savez does not append its own
        tmp = os.path.join(self.path, ".tmp_" + name)
        np.savez(tmp, **arrays)
        os.replace(tmp, os.path.join(self.path, name))

    def save_dense(self, vec, slot, version: int) -> None:
        self._write("dense.npz", vec=vec,
                    slot=(slot if slot is not None
                          else np.zeros_like(vec)),
                    version=np.int64(version))

    def load_dense(self):
        f = os.path.join(self.path, "dense.npz")
        if not os.path.exists(f):
            return None
        with np.load(f) as z:
            return z["vec"].copy(), z["slot"].copy(), int(z["version"])

    def save_sparse_delta(self, version: int, ids, rows, slots) -> None:
        with self._lock:
            self._write("sparse_delta_%012d.npz" % version,
                        ids=np.asarray(ids, np.int64),
                        rows=np.asarray(rows, np.float32),
                        slots=np.asarray(slots, np.float32))
        if self.compact_every and version % self.compact_every == 0:
            # off the caller's (server-lock-holding) thread: compaction
            # re-reads and rewrites O(table) files — pulls/pushes must
            # not stall behind that disk I/O. Single-flight: a still-
            # running compaction covers this round's deltas on its next
            # trigger (versions only grow).
            with self._lock:
                if (self._compact_thread is None
                        or not self._compact_thread.is_alive()):
                    self._compact_thread = threading.Thread(
                        target=self.compact, daemon=True,
                        name="ps-snapshot-compact")
                    self._compact_thread.start()

    def close(self, timeout: float = 10.0) -> None:
        """Bounded drain of the in-flight compaction (ParamServer.stop)."""
        with self._lock:
            t = self._compact_thread
            self._compact_thread = None
        if t is not None:
            t.join(timeout=timeout)

    def _delta_files(self):
        return sorted(
            f for f in os.listdir(self.path)
            if f.startswith("sparse_delta_"))

    def load_sparse(self):
        """(rows dict, slots dict, version): base + deltas in order."""
        rows: Dict[int, np.ndarray] = {}
        slots: Dict[int, np.ndarray] = {}
        version = 1
        base = os.path.join(self.path, "sparse_base.npz")
        if os.path.exists(base):
            with np.load(base) as z:
                for i, rid in enumerate(z["ids"]):
                    rows[int(rid)] = z["rows"][i].copy()
                    slots[int(rid)] = z["slots"][i].copy()
                version = int(z["version"])
        for f in self._delta_files():
            v = int(f[len("sparse_delta_"):-len(".npz")])
            if v < version:
                continue  # already folded into the base
            with np.load(os.path.join(self.path, f)) as z:
                for i, rid in enumerate(z["ids"]):
                    rows[int(rid)] = z["rows"][i].copy()
                    slots[int(rid)] = z["slots"][i].copy()
            version = v + 1
        return rows, slots, version

    def compact(self) -> None:
        # The slow part — reading base + deltas — runs WITHOUT the lock:
        # written files are immutable (base replace is atomic), and a
        # delta landing concurrently has version >= the one computed
        # here, so it survives the removal filter below. Only the short
        # base-write + delta-removal section excludes delta writers.
        rows, slots, version = self.load_sparse()
        if not rows:
            return
        ids = np.fromiter(rows.keys(), np.int64, len(rows))
        with self._lock:
            self._write("sparse_base.npz", ids=ids,
                        rows=np.stack([rows[int(i)] for i in ids]),
                        slots=np.stack([slots[int(i)] for i in ids]),
                        version=np.int64(version))
            for f in self._delta_files():
                v = int(f[len("sparse_delta_"):-len(".npz")])
                if v < version:
                    try:
                        os.remove(os.path.join(self.path, f))
                    except FileNotFoundError:
                        pass  # a concurrent compact got it first


def _pack_sparse(ids: np.ndarray, rows: np.ndarray) -> bytes:
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    return (np.int64(len(ids)).tobytes() + ids.tobytes() + rows.tobytes())


def _unpack_sparse(body: bytes, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    n = int(np.frombuffer(body[:8], dtype=np.int64)[0])
    ids = np.frombuffer(body[8:8 + 8 * n], dtype=np.int64)
    rows = np.frombuffer(body[8 + 8 * n:], dtype=np.float32).reshape(n, dim)
    return ids, rows


# ---------------------------------------------------------------------------
# pserver
# ---------------------------------------------------------------------------

class ParamServer:
    """One BSP parameter-server shard over HTTP.

    Protocol (all bodies raw little-endian fp32 unless noted):
      GET  /meta                  -> JSON {version, dim, n_trainers}
      POST /init                  -> body = this shard's initial values;
                                     first caller wins (idempotent)
      GET  /pull?after=N          -> long-poll until version > N, then
                                     X-Version header + shard bytes
      POST /push?worker=i&version=V -> gradient for version V; when all
                                     n_trainers arrive: SGD update,
                                     version += 1, pulls release
      POST /done?worker=i         -> trainer i finished; when ALL trainers
                                     have posted, the server stops serving
                                     (so pserver pods exit and the job can
                                     reach Completed)
      POST /shutdown              -> stop serving unconditionally

    Sparse-table extension (enabled by ``sparse_dim > 0``; same BSP
    contract, own version counter so a dense-only round and a sparse round
    release independently but advance in lockstep when the trainer loop
    drives both once per round):
      GET  /sparse/meta           -> JSON {version, dim, rows_resident}
      POST /sparse/pull?after=N   -> body = int64 ids; long-poll until
                                     sparse version > N, then X-Version +
                                     fp32 rows [n_ids, dim]
      POST /sparse/push?worker=i&version=V
                                  -> body = n|ids|row-grads; when all
                                     n_trainers arrive: per-row update,
                                     sparse version += 1, pulls release
    """

    def __init__(self, n_trainers: int, lr: float = 0.1,
                 momentum: float = 0.9, host: str = "127.0.0.1",
                 port: int = 0, sparse_dim: int = 0, sparse_seed: int = 0,
                 sparse_init_scale: float = 0.01,
                 snapshot_dir: Optional[str] = None):
        self.n_trainers = n_trainers
        self.lr, self.momentum = lr, momentum
        self._vec: Optional[np.ndarray] = None
        self._slot: Optional[np.ndarray] = None  # momentum buffer
        self.version = 0
        self.snap = SnapshotStore(snapshot_dir) if snapshot_dir else None
        self._grads: Dict[int, np.ndarray] = {}
        # worker -> last version whose push was ACCEPTED (per plane).
        # Client connection-retries re-send POSTs; a push that was already
        # counted before the connection dropped must be acked 200 (not
        # 409-stale), or the retry desynchronizes the BSP barrier: the
        # trainer would recompute and push AGAIN into the next round,
        # running one round ahead of the fleet forever.
        self._acked: Dict[int, int] = {}
        self._sacked: Dict[int, int] = {}
        # sparse shard: rows exist implicitly (lazy init), so version
        # starts live at 1 — there is no dense init transfer to wait for
        self.sparse = (SparseTable(sparse_dim, sparse_seed,
                                   sparse_init_scale)
                       if sparse_dim > 0 else None)
        self.sparse_version = 1
        self._sgrads: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._done: set = set()
        self._cond = threading.Condition()
        if self.snap is not None:
            # restore the last COMPLETED round: a crash mid-round lost
            # that round's in-memory pushes; trainers re-push on stall
            dense = self.snap.load_dense()
            if dense is not None:
                self._vec, self._slot, self.version = dense
            if self.sparse is not None:
                rows, slots, sver = self.snap.load_sparse()
                self.sparse.rows.update(rows)
                self.sparse.slots.update(slots)
                self.sparse_version = sver
            # Reconstruct the duplicate-ack state: an apply at round V
            # means EVERY worker's push at V was accepted (that is what
            # completes the barrier), so last-acked = restored version-1
            # per plane. Without this, a push whose 200 was lost in the
            # crash would be 409d on retry and desync the BSP barrier.
            if self.version > 1:
                self._acked = {w: self.version - 1
                               for w in range(self.n_trainers)}
            if self.sparse is not None and self.sparse_version > 1:
                self._sacked = {w: self.sparse_version - 1
                                for w in range(self.n_trainers)}
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self._thread: Optional[threading.Thread] = None

    @property
    def endpoint(self) -> str:
        h, p = self._httpd.server_address[:2]
        return "%s:%d" % (h, p)

    def start(self) -> "ParamServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="ps-serve-%s" % self.endpoint)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        if self.snap is not None:
            self.snap.close()

    def serve_forever(self) -> None:
        """Blocking entry for a dedicated pserver process/thread."""
        self._httpd.serve_forever()

    # -- update rule ------------------------------------------------------

    def _apply(self) -> None:
        # caller holds self._cond
        grad = np.mean(list(self._grads.values()), axis=0)
        if self._slot is None:
            self._slot = np.zeros_like(self._vec)
        self._slot = self.momentum * self._slot + grad
        self._vec = self._vec - self.lr * self._slot
        self._grads.clear()
        self.version += 1
        if self.snap is not None:
            # inside the lock: a pull must never observe a version whose
            # state could be lost to a crash an instant later
            self.snap.save_dense(self._vec, self._slot, self.version)
        self._cond.notify_all()

    def _handler(server_self):  # noqa: N805 — closure over the server
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code=200, body=b"", headers=()):
                self.send_response(code)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                s = server_self
                if self.path.startswith("/sparse/meta"):
                    with s._cond:
                        body = json.dumps({
                            "version": s.sparse_version,
                            "dim": 0 if s.sparse is None else s.sparse.dim,
                            "rows_resident": (
                                0 if s.sparse is None
                                else len(s.sparse.rows)),
                        }).encode()
                    self._send(200, body,
                               [("Content-Type", "application/json")])
                    return
                if self.path.startswith("/meta"):
                    with s._cond:
                        body = json.dumps({
                            "version": s.version,
                            "dim": -1 if s._vec is None else len(s._vec),
                            "n_trainers": s.n_trainers,
                        }).encode()
                    self._send(200, body,
                               [("Content-Type", "application/json")])
                    return
                if self.path.startswith("/pull"):
                    after = -1
                    if "after=" in self.path:
                        after = int(self.path.split("after=")[1].split("&")[0])
                    with s._cond:
                        ok = s._cond.wait_for(
                            lambda: s._vec is not None and s.version > after,
                            timeout=30.0)
                        if not ok:
                            self._send(408)
                            return
                        body = s._vec.tobytes()
                        ver = s.version
                    self._send(200, body, [("X-Version", str(ver))])
                    return
                self._send(404)

            def do_POST(self):
                s = server_self
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if self.path.startswith("/sparse/pull"):
                    after = 0
                    if "after=" in self.path:
                        after = int(self.path.split("after=")[1].split("&")[0])
                    ids = np.frombuffer(body, dtype=np.int64)
                    with s._cond:
                        ok = s._cond.wait_for(
                            lambda: s.sparse is not None
                            and s.sparse_version > after,
                            timeout=30.0)
                        if not ok:
                            self._send(408)
                            return
                        rows = s.sparse.gather(ids)
                        ver = s.sparse_version
                    self._send(200, rows.tobytes(),
                               [("X-Version", str(ver))])
                    return
                if self.path.startswith("/sparse/push"):
                    q = dict(kv.split("=") for kv in
                             self.path.split("?", 1)[1].split("&"))
                    worker, ver = int(q["worker"]), int(q["version"])
                    ids, grads = _unpack_sparse(body, s.sparse.dim)
                    with s._cond:
                        if ver != s.sparse_version:
                            if s._sacked.get(worker) == ver:
                                self._send(200)  # duplicate re-send of an
                                return           # already-counted push
                            self._send(409)  # stale round, same as dense
                            return
                        s._sacked[worker] = ver
                        s._sgrads[worker] = (ids, grads)
                        if len(s._sgrads) >= s.n_trainers:
                            touched = s.sparse.apply(
                                list(s._sgrads.values()),
                                s.lr, s.momentum, s.n_trainers)
                            if s.snap is not None:
                                # empty rounds too: the version bump must
                                # persist, or a restart rewinds the shard
                                # behind the fleet and deadlocks it
                                s.snap.save_sparse_delta(
                                    s.sparse_version,
                                    touched,
                                    [s.sparse.rows[r] for r in touched],
                                    [s.sparse.slots[r] for r in touched])
                            s._sgrads.clear()
                            s.sparse_version += 1
                            s._cond.notify_all()
                    self._send(200)
                    return
                if self.path.startswith("/init"):
                    vec = np.frombuffer(body, dtype=np.float32).copy()
                    with s._cond:
                        if s._vec is None:
                            s._vec = vec
                            s.version = 1
                            if s.snap is not None:
                                # a restart before the first apply must
                                # not lose the init (pulls would block
                                # forever; stall-re-push cannot help)
                                s.snap.save_dense(s._vec, s._slot,
                                                  s.version)
                            s._cond.notify_all()
                    self._send(200)
                    return
                if self.path.startswith("/push"):
                    q = dict(kv.split("=") for kv in
                             self.path.split("?", 1)[1].split("&"))
                    worker, ver = int(q["worker"]), int(q["version"])
                    grad = np.frombuffer(body, dtype=np.float32)
                    with s._cond:
                        if ver != s.version:
                            if s._acked.get(worker) == ver:
                                self._send(200)  # duplicate re-send of an
                                return           # already-counted push
                            # stale push (BSP: only current-version grads
                            # count); trainer re-pulls and recomputes
                            self._send(409)
                            return
                        s._acked[worker] = ver
                        s._grads[worker] = grad
                        if len(s._grads) >= s.n_trainers:
                            s._apply()
                    self._send(200)
                    return
                if self.path.startswith("/done"):
                    q = dict(kv.split("=") for kv in
                             self.path.split("?", 1)[1].split("&"))
                    self._send(200)
                    with s._cond:
                        s._done.add(int(q["worker"]))
                        all_done = len(s._done) >= s.n_trainers
                    if all_done:
                        threading.Thread(target=s._httpd.shutdown,
                                         daemon=True,
                                         name="ps-shutdown").start()
                    return
                if self.path.startswith("/shutdown"):
                    self._send(200)
                    threading.Thread(target=s._httpd.shutdown,
                                     daemon=True,
                                     name="ps-shutdown").start()
                    return
                self._send(404)

        return Handler


# ---------------------------------------------------------------------------
# trainer-side client
# ---------------------------------------------------------------------------

class PsClient:
    """Trainer's view of the sharded server fleet.

    ``bytes_sent`` / ``bytes_recv`` count request/response BODY bytes —
    the traffic the sparse path exists to shrink; tests assert per-round
    bytes scale with touched rows, not table size.
    """

    def __init__(self, endpoints: List[str], worker_id: int):
        self.urls = ["http://%s" % e for e in endpoints]
        self.worker_id = worker_id
        self.ranges: Optional[List[Tuple[int, int]]] = None
        self.bytes_sent = 0
        self.bytes_recv = 0

    def _req(self, url, data=None, timeout=35.0, retry_s=60.0):
        """One HTTP round trip. HTTP errors are returned as (code, ...) for
        the caller's protocol logic; CONNECTION-level failures (refused —
        a pserver pod not yet listening when a released trainer fires
        /init; reset — a pserver restart mid-job) are retried with backoff
        for up to ``retry_s`` before propagating, so a transient does not
        cost the whole training cycle to restartPolicy=OnFailure."""
        t0 = time.monotonic()
        delay = 0.2
        while True:
            req = urllib.request.Request(url, data=data, method=(
                "POST" if data is not None else "GET"))
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    body = resp.read()
                    self.bytes_sent += len(data) if data else 0
                    self.bytes_recv += len(body)
                    return resp.status, body, dict(resp.headers)
            except urllib.error.HTTPError as e:
                body = e.read()
                self.bytes_sent += len(data) if data else 0
                self.bytes_recv += len(body)
                return e.code, body, dict(e.headers)
            except (urllib.error.URLError, OSError):
                if time.monotonic() - t0 + delay > retry_s:
                    raise
                time.sleep(delay)
                delay = min(delay * 2, 5.0)

    def init(self, vec: np.ndarray) -> None:
        self.ranges = shard_ranges(len(vec), len(self.urls))
        for url, (a, b) in zip(self.urls, self.ranges):
            self._req(url + "/init", vec[a:b].tobytes())

    def _long_poll(self, url: str, data: Optional[bytes], t0: float,
                   deadline_s: float, on_stall=None) -> Tuple[bytes, dict]:
        """Re-arm a long-poll request until 200. A server-side 408 is just
        the 30 s poll window expiring (e.g. a straggler trainer still
        computing its gradient) — keep waiting until `deadline_s` from
        `t0`; any other status is a server fault, raised as such.

        ``on_stall`` fires every second consecutive 408 (~60 s of no
        progress): a restarted pserver restores only COMPLETED rounds, so
        this round's in-memory pushes may be gone — the caller re-pushes
        them (idempotent in every case: in-flight round overwrites the
        same payload, applied round is acked as duplicate, restarted
        server counts the replay)."""
        stalls = 0
        while True:
            status, body, headers = self._req(url, data)
            if status == 200:
                return body, headers
            if status != 408:
                raise RuntimeError("poll %s: HTTP %s" % (url, status))
            stalls += 1
            if on_stall is not None and stalls % 2 == 0:
                on_stall()
            if time.monotonic() - t0 > deadline_s:
                raise TimeoutError(
                    "poll %s: no new version after %.0fs"
                    % (url, time.monotonic() - t0))

    def pull(self, after: int, deadline_s: float = 600.0,
             on_stall=None) -> Tuple[np.ndarray, int]:
        """Long-poll every shard for version > after."""
        t0 = time.monotonic()
        parts, version = [], None
        for url in self.urls:
            body, headers = self._long_poll(
                "%s/pull?after=%d" % (url, after), None, t0, deadline_s,
                on_stall=on_stall)
            parts.append(np.frombuffer(body, dtype=np.float32))
            v = int(headers.get("X-Version", "0"))
            version = v if version is None else min(version, v)
        return np.concatenate(parts), version

    def push(self, grad_vec: np.ndarray, version: int) -> bool:
        """True if every shard accepted; False on a stale-version 409."""
        ok = True
        for url, (a, b) in zip(self.urls, self.ranges):
            status, _, _ = self._req(
                "%s/push?worker=%d&version=%d"
                % (url, self.worker_id, version), grad_vec[a:b].tobytes())
            if status == 409:
                ok = False  # stale round: caller re-pulls and recomputes
            elif status != 200:
                raise RuntimeError("push to %s: HTTP %s" % (url, status))
        return ok

    # -- sparse embedding rows -------------------------------------------

    def _split_ids(self, ids: np.ndarray) -> List[np.ndarray]:
        """Row-shard by id % n_servers. Returns per-server LOCAL positions
        into `ids` so pulls reassemble and pushes route grads correctly."""
        ids = np.asarray(ids, dtype=np.int64)
        return [np.nonzero(ids % len(self.urls) == k)[0]
                for k in range(len(self.urls))]

    def sparse_pull(self, ids: np.ndarray, after: int, dim: int,
                    deadline_s: float = 600.0,
                    on_stall=None) -> Tuple[np.ndarray, int]:
        """Rows for `ids` (any order, duplicates allowed) at a version >
        `after`, from every owning server. Servers that own none of the
        ids still participate in the version long-poll — BSP lockstep is
        fleet-wide, not just where this batch's ids happen to live."""
        ids = np.asarray(ids, dtype=np.int64)
        out = np.zeros((len(ids), dim), np.float32)
        t0 = time.monotonic()
        version = None
        for url, pos in zip(self.urls, self._split_ids(ids)):
            body, headers = self._long_poll(
                "%s/sparse/pull?after=%d" % (url, after),
                ids[pos].tobytes(), t0, deadline_s, on_stall=on_stall)
            rows = np.frombuffer(body, dtype=np.float32).reshape(-1, dim)
            out[pos] = rows
            v = int(headers.get("X-Version", "0"))
            version = v if version is None else min(version, v)
        return out, version

    def sparse_push(self, ids: np.ndarray, grads: np.ndarray,
                    version: int) -> bool:
        """True if every shard accepted; False on a stale-version 409.
        Every server gets a push (possibly with zero rows): the BSP
        barrier counts trainers, so absence would stall the round."""
        ids = np.asarray(ids, dtype=np.int64)
        grads = np.asarray(grads, dtype=np.float32)
        ok = True
        for url, pos in zip(self.urls, self._split_ids(ids)):
            status, _, _ = self._req(
                "%s/sparse/push?worker=%d&version=%d"
                % (url, self.worker_id, version),
                _pack_sparse(ids[pos], grads[pos]))
            if status == 409:
                ok = False
            elif status != 200:
                raise RuntimeError(
                    "sparse push to %s: HTTP %s" % (url, status))
        return ok

    def done(self) -> None:
        """Tell every shard this trainer finished; servers stop once ALL
        trainers have — the shutdown path that lets pserver pods exit so
        the job reaches Completed."""
        for url in self.urls:
            try:
                self._req("%s/done?worker=%d" % (url, self.worker_id), b"")
            except Exception:
                pass

    def shutdown_servers(self) -> None:
        for url in self.urls:
            try:
                self._req(url + "/shutdown", b"")
            except Exception:
                pass


# ---------------------------------------------------------------------------
# role dispatch: the launch.py surface
# ---------------------------------------------------------------------------

@dataclass
class PsTrainJob:
    init_params: Callable      # torch.Generator -> params tree
    loss_fn: Callable          # dense: (params, batch) -> (loss, metrics)
    #                            sparse: (params, rows, inv, batch) -> same,
    #                            where the model's embedding lookup is
    #                            rows[inv] (rows = pulled unique-id rows)
    make_batch: Callable       # (torch.Generator, step) -> batch
    total_steps: int = 10
    lr: float = 0.1
    momentum: float = 0.9
    seed: int = 0
    embed_dim: int = 0         # >0 enables the sparse embedding path
    ids_fn: Optional[Callable] = None  # batch -> raw int64 ids (any shape)
    # pserver fault tolerance: each pserver persists its shard here (its
    # own ps<idx>/ subdir) and restores it on restart
    snapshot_dir: str = ""
    # where a trainer computes: None means CUDA (and raises without a
    # card); pservers place nothing on any device
    device: DeviceLike = None


def batch_generator(worker_id: int, step: int,
                    device: DeviceLike = None) -> torch.Generator:
    """The generator trainer ``worker_id`` draws step ``step``'s batch
    from: ``(1000 + worker_id, step)``, the reference's
    ``fold_in(PRNGKey(1000 + worker_id), step)``."""
    return step_generator(1000 + worker_id, step, device)


def init_vector(job: PsTrainJob, device: DeviceLike = None):
    """``(vec, structure, shapes)`` of ``job.init_params`` drawn from
    ``job.seed`` on ``device``: what every trainer posts to ``/init``."""
    dev = resolve_device(device, "ps.init_vector")
    return flatten_params(job.init_params(
        torch.Generator(device=dev).manual_seed(job.seed)))


def loss_and_grads(loss_fn: Callable, params: Any, *args,
                   grad_args: Tuple[torch.Tensor, ...] = ()):
    """``(loss, params' gradient as a flat host fp32 vector, the
    gradients of grad_args)`` of ``loss_fn(params, *grad_args, *args)``
    by autograd, from one forward."""
    flat = bridge.flatten(params)
    views = {k: t.detach().requires_grad_() for k, t in flat.items()}
    extra = [t.detach().requires_grad_() for t in grad_args]
    with torch.enable_grad():
        loss, _ = loss_fn(bridge.unflatten(bridge.structure(params), views),
                          *extra, *args)
        got = torch.autograd.grad(loss, list(views.values()) + extra,
                                  allow_unused=True)
    # a leaf autograd did not reach gets zeros, as jax.grad gives
    got = [torch.zeros_like(t) if g is None else g
           for t, g in zip(list(views.values()) + extra, got)]
    return (loss.detach(), _flat_vector(got[:len(views)]),
            tuple(got[len(views):]))


def run_ps_training(job: PsTrainJob, cfg, bind_host: str = "",
                    server: Optional[ParamServer] = None) -> dict:
    """Entry for BOTH roles, driven by the operator env via
    ``launch.detect_env()`` (cfg.role, cfg.ps_endpoints, cfg.worker_id,
    cfg.num_workers).

    PSERVER: serve this host's shard until every trainer posts /done
    (or something posts /shutdown), then return so the pod completes. It
    resolves no device and never calls ``torch.cuda``.
    TRAINER: init (the deterministic init is identical on every node;
    first /init wins), then pull -> grad -> push for ``total_steps`` BSP
    rounds on ``job.device``, then post /done.
    """
    if cfg.role == "PSERVER":
        if server is None:
            # bind the port this pserver advertises in the env
            my = cfg.ps_endpoints[cfg.worker_id]
            host, _, port = my.partition(":")
            server = ParamServer(
                n_trainers=cfg.num_workers, lr=job.lr,
                momentum=job.momentum,
                host=bind_host or host, port=int(port),
                sparse_dim=job.embed_dim, sparse_seed=job.seed,
                snapshot_dir=(os.path.join(job.snapshot_dir,
                                           "ps%d" % cfg.worker_id)
                              if job.snapshot_dir else None))
        server.serve_forever()
        return {"role": "PSERVER"}

    dev = resolve_device(job.device, "run_ps_training")
    vec0, treedef, shapes = init_vector(job, dev)
    client = PsClient(cfg.ps_endpoints, cfg.worker_id)
    client.init(vec0)

    losses: List[float] = []
    if job.embed_dim > 0:
        result = _train_sparse(job, client, treedef, shapes, dev,
                               cfg.worker_id, losses)
        client.done()
        return result

    def grads(vec, batch):
        return loss_and_grads(job.loss_fn,
                              unflatten_params(vec, treedef, shapes, dev),
                              batch)[:2]

    # one full-vector pull per BSP round: the end-of-round barrier pull
    # doubles as the next round's parameter fetch (the vector transfer is
    # the dominant PS-mode cost for CTR models)
    vec, version = client.pull(after=0)
    for step in range(job.total_steps):
        batch = job.make_batch(batch_generator(cfg.worker_id, step, dev),
                               step)
        loss, gvec = grads(vec, batch)
        # PS-mode BSP rounds are host-synchronous by protocol: the push
        # below copies the whole gradient to the host anyway
        losses.append(float(loss))
        while not client.push(gvec, version):
            # stale: another BSP round completed while we computed;
            # re-pull and recompute on fresh params
            vec, version = client.pull(after=version)
            _, gvec = grads(vec, batch)
        # barrier: our round applied; this pull is also next round's
        # fetch. on_stall replays the push: a pserver restart restores
        # only completed rounds, so this round's push may be gone.
        vec, version = client.pull(
            after=version,
            on_stall=lambda g=gvec, v=version: client.push(g, v))
    client.done()  # all trainers done -> servers stop -> pods Complete
    final = unflatten_params(vec, treedef, shapes, dev)
    return {"role": "TRAINER", "losses": losses, "params": final,
            "version": version, "bytes_sent": client.bytes_sent,
            "bytes_recv": client.bytes_recv}


def unique_ids(raw_ids) -> Tuple[np.ndarray, np.ndarray]:
    """``(uids, inv)`` of a batch's raw ids: the sorted unique ids and,
    for each raw id, its index into them (raveled: numpy 2.0.0 returned
    the inverse in the input's shape)."""
    uids, inv = np.unique(np.asarray(raw_ids, np.int64).ravel(),
                          return_inverse=True)
    return uids, inv.ravel()


def _train_sparse(job: PsTrainJob, client: PsClient, treedef, shapes,
                  dev: torch.device, worker_id: int, losses) -> dict:
    """Sparse-embedding BSP trainer loop: per round, pull only the rows
    this batch touches, compute grads w.r.t. (dense params, pulled rows),
    push both under the round's versions."""
    vec, version = client.pull(after=0)
    sver = 0
    dim = job.embed_dim
    prev_spush = None  # last completed (uids, grads, version) sparse push
    for step in range(job.total_steps):
        batch = job.make_batch(batch_generator(worker_id, step, dev), step)
        uids, inv = unique_ids(job.ids_fn(batch))
        inv_t = torch.from_numpy(inv).to(dev)
        # this pull is also the previous round's sparse barrier: on a
        # stall, replay the previous push (a restarted pserver restores
        # only completed rounds; 409-stale replays are ignored)
        rows, sver = client.sparse_pull(
            uids, after=sver, dim=dim,
            on_stall=(None if prev_spush is None else
                      (lambda p=prev_spush: client.sparse_push(*p))))
        while True:
            params = unflatten_params(vec, treedef, shapes, dev)
            loss, gvec, (grows,) = loss_and_grads(
                job.loss_fn, params, inv_t, batch,
                grad_args=(torch.from_numpy(rows).to(dev),))
            # the sparse push IS a host transfer: the embedding-row
            # gradients must be host bytes this round, by protocol
            grows = grows.cpu().numpy()
            ok_dense = client.push(gvec, version)
            ok_sparse = client.sparse_push(uids, grows, sver)
            if ok_dense and ok_sparse:
                prev_spush = (uids, grows, sver)
                break
            # stale round (another BSP round completed while we computed):
            # re-pull BOTH planes and recompute on fresh state. A half-
            # accepted push is consumed by that round's barrier on the
            # accepting plane; re-pushing under the fresh versions below
            # keeps both planes advancing one round per loop iteration.
            vec, version = client.pull(after=version)
            rows, sver = client.sparse_pull(uids, after=sver, dim=dim)
        # host-synchronous by protocol, like the dense loop
        losses.append(float(loss))
        # barrier: dense plane applied; this pull is next round's fetch.
        # The sparse barrier is implicit in the NEXT round's sparse_pull
        # (after=sver long-polls until the round applies): no extra trip.
        vec, version = client.pull(
            after=version,
            on_stall=lambda g=gvec, v=version: client.push(g, v))
    final = unflatten_params(vec, treedef, shapes, dev)
    return {"role": "TRAINER", "losses": losses, "params": final,
            "version": version, "sparse_version": sver,
            "bytes_sent": client.bytes_sent,
            "bytes_recv": client.bytes_recv, "client": client}
