"""Parameter-server checks, run as the processes of a real PS world.

:func:`launch_world` starts, from a parent process, the pods of a PS
world the way the operator renders them, on one machine: for every
scenario of a JSON spec, ``n_servers`` pservers through the example
itself (``examples/train_wide_deep_ps.py`` with ``TRAINING_ROLE=PSERVER``
and ``CUDA_VISIBLE_DEVICES=""``: a pserver never needs a card), and
``n_trainers`` trainer processes, one a worker id, that run the spec's
scenarios in order::

    TRAINING_ROLE=TRAINER PADDLE_TRAINER_ID=<w> PADDLE_TRAINERS_NUM=<n> \\
    PADDLE_PSERVERS_IP_PORT_LIST=<host:port,...> \\
        python -m paddle_operator_tpu_torch.ps_check SPEC.json

A trainer runs ``train_wide_deep_ps.make_job`` (over the scenario's
model and env) through ``ps.run_ps_training``. The only part of
the rendered env a scenario rewrites is the host:port list, to its own
pservers' loopback ports. Each trainer writes ``<out>/<scenario>.trainer
<w>.npz``: its losses, its final flat vector, its wire byte counts, the
unique ids of each round and the start time of each round. The pservers
exit by the done protocol; :func:`launch_world` records their exit codes.

:func:`replay` recomputes a world in one process: each round's
gradients of every trainer from the same init, batches and versions,
their mean by ``np.mean`` and the momentum update in numpy as
``ps.ParamServer`` applies them, and the sparse rows through a
``ps.SparseTable``. For two trainers it must give the trainers' final
vector bit for bit: the server's mean and the per-row sums add two
operands, which commute.

Planted faults (:func:`planted`), each of which a gate must catch:

* ``leaf_order``: the trainer flattens its tree in dict insertion order,
  not the JAX package's sorted order. Its trainers agree with each
  other and its loss still falls; only the replay sees it.
* ``stale_rows``: a sparse pull that does not wait for the round's
  barrier (``after=sver-1``). A scenario's ``straggle_s`` delays the
  last trainer's sparse pushes, so that the others read rows the round
  has not updated yet; a sound world is bitwise unmoved by the delay.

``tests/test_torch_ps.py`` starts one world on the CPU and
``chip_smoke.py``'s train_ctr phase one on the card.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from paddle_operator_tpu_torch import bridge, launch, ps
from paddle_operator_tpu_torch.device import resolve_device
from paddle_operator_tpu_torch.examples import train_wide_deep_ps
from paddle_operator_tpu_torch.models import deepfm, wide_deep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "paddle_operator_tpu_torch", "examples",
                       "train_wide_deep_ps.py")
MODELS = {"wide_deep": wide_deep, "deepfm": deepfm}


def scenario_job(sc: dict, device=None) -> ps.PsTrainJob:
    """The example's PsTrainJob for a scenario, on ``device``. With
    ``fixed_batch``, every trainer trains every round on one batch (drawn
    from seed 1 on the device): on random labels, fresh batches make the
    loss sequence batch noise, and on one batch the model must memorise
    (``tests/test_ps_mode.py``'s DeepFM test does the same)."""
    job = train_wide_deep_ps.make_job(sc["env"], MODELS[sc["model"]])
    job.device = device
    if sc.get("fixed_batch"):
        draw, fixed = job.make_batch, []

        def one_batch(gen, step):
            if not fixed:
                fixed.append(draw(torch.Generator(
                    device=gen.device).manual_seed(1), 0))
            return fixed[0]
        job.make_batch = one_batch
    return job


# ---------------------------------------------------------------------------
# planted faults
# ---------------------------------------------------------------------------

def _insertion_order_flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``bridge.flatten`` without sorting the dict keys."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in tree:
            out.update(_insertion_order_flatten(tree[k],
                                                "%s%s/" % (prefix, k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_insertion_order_flatten(v, "%s%d/" % (prefix, i)))
    else:
        out[prefix[:-1]] = tree
    return out


@contextlib.contextmanager
def _patched(obj, name: str, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def planted(fault: str):
    """Plant ``fault`` ("" for none) in this process for the block."""
    if not fault:
        yield
    elif fault == "leaf_order":
        with _patched(bridge, "flatten", _insertion_order_flatten):
            yield
    elif fault == "stale_rows":
        pull = ps.PsClient.sparse_pull

        def stale(self, ids, after, dim, **kw):
            return pull(self, ids, after=after - 1, dim=dim, **kw)

        with _patched(ps.PsClient, "sparse_pull", stale):
            yield
    else:
        raise ValueError("no planted fault %r" % fault)


@contextlib.contextmanager
def straggling(seconds: float):
    """Delay every sparse push of this process by ``seconds``."""
    if not seconds:
        yield
        return
    push = ps.PsClient.sparse_push

    def late(self, *a, **kw):
        time.sleep(seconds)
        return push(self, *a, **kw)

    with _patched(ps.PsClient, "sparse_push", late):
        yield


# ---------------------------------------------------------------------------
# the trainer process
# ---------------------------------------------------------------------------

def _run_trainer(sc: dict, spec: dict, worker: int, n_trainers: int
                 ) -> Dict[str, Any]:
    job = scenario_job(sc, spec.get("device"))
    starts: List[float] = []
    uniques: List[int] = []
    make_batch, ids_fn = job.make_batch, job.ids_fn

    def timed_batch(gen, step):
        starts.append(time.perf_counter())
        return make_batch(gen, step)

    job.make_batch = timed_batch
    if ids_fn is not None:
        def counted_ids(batch):
            ids = ids_fn(batch)
            uniques.append(len(np.unique(ids)))
            return ids
        job.ids_fn = counted_ids
    # the rendered env with only the host:port list rewritten
    cfg = launch.detect_env(dict(
        os.environ, PADDLE_PSERVERS_IP_PORT_LIST=sc["endpoints"]))
    straggle = sc.get("straggle_s", 0.0) if worker == n_trainers - 1 else 0
    with planted(sc.get("fault", "")), straggling(straggle):
        out = ps.run_ps_training(job, cfg)
        vec = ps.flatten_params(out["params"])[0]
    starts.append(time.perf_counter())
    return {"losses": np.asarray(out["losses"], np.float64),
            "vector": vec, "version": out["version"],
            "sparse_version": out.get("sparse_version", -1),
            "bytes_sent": out.get("bytes_sent", -1),
            "bytes_recv": out.get("bytes_recv", -1),
            "uniques": np.asarray(uniques, np.int64),
            "round_s": np.diff(np.asarray(starts))}


def trainer_main(spec_path: str) -> int:
    """Run a spec's scenarios as trainer ``PADDLE_TRAINER_ID``."""
    with open(spec_path) as f:
        spec = json.load(f)
    base = launch.detect_env()
    if base.role != "TRAINER":
        raise SystemExit("ps_check runs trainers; pservers run the example")
    if spec.get("deterministic"):
        torch.use_deterministic_algorithms(True)
    for sc in spec["scenarios"]:
        out = _run_trainer(sc, spec, base.worker_id, base.num_workers)
        np.savez(os.path.join(spec["out"], "%s.trainer%d.npz"
                              % (sc["name"], base.worker_id)), **out)
    return 0


# ---------------------------------------------------------------------------
# the replay
# ---------------------------------------------------------------------------

def replay(job: ps.PsTrainJob, n_trainers: int, device=None
           ) -> Dict[str, Any]:
    """A world of ``n_trainers`` recomputed in this process on
    ``device``: the final flat vector and each trainer's losses, as BSP
    rounds compute them (the server's arithmetic, in numpy)."""
    dev = resolve_device(device, "ps_check.replay")
    vec, treedef, shapes = ps.init_vector(job, dev)
    slot = None
    table = (ps.SparseTable(job.embed_dim, job.seed)
             if job.embed_dim > 0 else None)
    losses: List[List[float]] = [[] for _ in range(n_trainers)]
    for step in range(job.total_steps):
        grads, row_grads = [], []
        for w in range(n_trainers):
            batch = job.make_batch(ps.batch_generator(w, step, dev), step)
            params = ps.unflatten_params(vec, treedef, shapes, dev)
            if table is None:
                loss, gvec, _ = ps.loss_and_grads(job.loss_fn, params, batch)
            else:
                uids, inv = ps.unique_ids(job.ids_fn(batch))
                rows = torch.from_numpy(table.gather(uids)).to(dev)
                loss, gvec, (grows,) = ps.loss_and_grads(
                    job.loss_fn, params, torch.from_numpy(inv).to(dev),
                    batch, grad_args=(rows,))
                row_grads.append((uids, grows.cpu().numpy()))
            grads.append(gvec)
            losses[w].append(float(loss))
        # ParamServer._apply on the whole vector (its shards are slices)
        grad = np.mean(grads, axis=0)
        if slot is None:
            slot = np.zeros_like(vec)
        slot = job.momentum * slot + grad
        vec = vec - job.lr * slot
        if table is not None:
            table.apply(row_grads, job.lr, job.momentum, n_trainers)
    return {"vector": vec, "losses": losses, "table": table}


def expected_bytes_sent(n_dense: int, uniques, n_servers: int,
                        row_dim: int) -> int:
    """A sparse trainer's request bytes: the ``/init`` post of the dense
    vector, then a round's dense push (``4 N``), sparse pull request (the
    ids, ``8 n``) and sparse push (``n|ids|rows`` to every server: ``8
    n_servers + (8 + 4 row_dim) n``); ``/done`` posts nothing."""
    return 4 * n_dense + sum(
        4 * n_dense + 8 * n + 8 * n_servers + (8 + 4 * row_dim) * n
        for n in map(int, uniques))


# ---------------------------------------------------------------------------
# the parent's side
# ---------------------------------------------------------------------------

def free_ports(n: int) -> List[int]:
    """``n`` distinct free loopback ports: bound together, so that no two
    are the same, then released for the pservers to bind."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _pythonpath() -> str:
    return os.pathsep.join([REPO] + [p for p in os.environ.get(
        "PYTHONPATH", "").split(os.pathsep) if p])


def _popen(args, env, log_path):
    with open(log_path, "w") as log:
        return subprocess.Popen(args, cwd=REPO, env=env, stdout=log,
                                stderr=subprocess.STDOUT)


def _tail(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()[-4000:]
    except OSError:
        return ""


def _wait_serving(endpoint: str, proc: subprocess.Popen, log: str,
                  timeout: float = 60.0) -> None:
    """Wait until ``proc`` answers ``/meta`` at ``endpoint`` (a pserver
    that lost its port to another process exits instead)."""
    deadline = time.monotonic() + timeout
    while True:
        if proc.poll() is not None:
            raise RuntimeError("pserver %s exited %d:\n%s"
                               % (endpoint, proc.returncode, _tail(log)))
        try:
            with urllib.request.urlopen("http://%s/meta" % endpoint,
                                        timeout=1.0) as resp:
                json.loads(resp.read())["n_trainers"]
            if proc.poll() is None:
                return
        except (OSError, ValueError, KeyError):
            if time.monotonic() > deadline:
                raise RuntimeError("pserver %s not listening after %.0f s"
                                   % (endpoint, timeout))
            time.sleep(0.05)


def launch_world(spec: dict, n_trainers: int = 2, n_servers: int = 2,
                 timeout: float = 600.0,
                 env: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Start every scenario's pservers and the trainers, wait for the
    trainers (killing every process if one fails or the time runs out),
    then for the pservers to exit by the done protocol. Returns
    ``{scenario: {"trainers": [npz dicts], "pserver_rcs": [...],
    "endpoints": "..."}}``; ``spec["scenarios"]`` gain their
    ``endpoints``."""
    out = spec["out"]
    os.makedirs(out, exist_ok=True)
    penv = dict(os.environ, **(env or {}))
    penv["PYTHONPATH"] = _pythonpath()
    ports = iter(free_ports(n_servers * len(spec["scenarios"])))
    for sc in spec["scenarios"]:
        sc["endpoints"] = ",".join("127.0.0.1:%d" % next(ports)
                                   for _ in range(n_servers))
    path = os.path.join(out, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    servers: Dict[str, list] = {}
    procs: List[subprocess.Popen] = []
    try:
        # every pserver, then the trainers once each serves its endpoint
        pending = []
        for sc in spec["scenarios"]:
            servers[sc["name"]] = []
            for i, ep in enumerate(sc["endpoints"].split(",")):
                senv = dict(penv, **sc["env"])
                senv.update(TRAINING_ROLE="PSERVER", PADDLE_TRAINER_ID=str(i),
                            PADDLE_TRAINERS_NUM=str(n_trainers),
                            PADDLE_PSERVERS_IP_PORT_LIST=sc["endpoints"],
                            CUDA_VISIBLE_DEVICES="")
                log = os.path.join(out, "%s.pserver%d.log" % (sc["name"], i))
                p = _popen([sys.executable, EXAMPLE], senv, log)
                servers[sc["name"]].append(p)
                procs.append(p)
                pending.append((ep, p, log))
        for ep, p, log in pending:
            _wait_serving(ep, p, log)
        trainers = []
        for w in range(n_trainers):
            tenv = dict(penv, TRAINING_ROLE="TRAINER",
                        PADDLE_TRAINER_ID=str(w),
                        PADDLE_TRAINERS_NUM=str(n_trainers),
                        PADDLE_PSERVERS_IP_PORT_LIST=spec["scenarios"][0][
                            "endpoints"])
            p = _popen([sys.executable, "-m",
                        "paddle_operator_tpu_torch.ps_check", path], tenv,
                       os.path.join(out, "trainer%d.log" % w))
            trainers.append(p)
            procs.append(p)
        deadline = time.monotonic() + timeout
        for w, p in enumerate(trainers):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError("ps trainer %d timed out after %.0f s:\n%s"
                                   % (w, timeout, _tail(os.path.join(
                                       out, "trainer%d.log" % w))))
            if p.returncode != 0:
                raise RuntimeError("ps trainer %d exited %d:\n%s" % (
                    w, p.returncode,
                    _tail(os.path.join(out, "trainer%d.log" % w))))
        result: Dict[str, Any] = {}
        for sc in spec["scenarios"]:
            rcs = []
            for p in servers[sc["name"]]:
                try:
                    rcs.append(p.wait(timeout=30))
                except subprocess.TimeoutExpired:
                    rcs.append(None)   # kept serving after every /done
            runs = []
            for w in range(n_trainers):
                with np.load(os.path.join(out, "%s.trainer%d.npz"
                                          % (sc["name"], w))) as z:
                    runs.append({k: z[k] for k in z.files})
            result[sc["name"]] = {"trainers": runs, "pserver_rcs": rcs,
                                  "endpoints": sc["endpoints"]}
        return result
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


if __name__ == "__main__":
    sys.exit(trainer_main(sys.argv[1]))
