"""Parameter-server mode of the torch port (``ps.py``, ``ps_check.py``,
``examples/train_wide_deep_ps.py``, the PS fields of ``launch.py``)
against the JAX package's ``ps.py``, on the CPU.

* The flat vector: ``flatten_params`` of a bridged tree is bitwise the
  JAX package's (its sorted leaf order, not insertion order), and
  ``shard_ranges`` agree.
* The wire: the port's ``ParamServer`` and the JAX package's reach
  bitwise the same state for the same pushes; a JAX ``PsClient`` trains
  against a port server and a port client against a JAX server;
  snapshots written by either side load in the other; a duplicate push
  is acked, a stale one refused with 409.
* Live worlds in threads, as ``tests/test_ps_mode.py`` runs them: the
  operator renders the PS env (``OperatorHarness``), the port's
  ``detect_env`` parses it, 2 port pservers and 2 port trainers train
  (final vectors bitwise equal, loss falls, servers exit by the done
  protocol); JAX trainers on the same init vector and batches in fp32
  reach the port trainers' final vector within 1e-5, alone and sharing
  one fleet with a port trainer; the sparse mode of both models moves
  bytes by touched rows, not table size; a pserver restart mid-training
  is bit-transparent; the pserver role never initialises CUDA, and a
  trainer without a card refuses to run unless given ``device="cpu"``.
* One world of processes (``ps_check.launch_world``, the pservers through
  the example, as ``chip_smoke.py``'s train_ctr phase starts them on the
  card), wide&deep's jobs at full width, batch 64, 3 rounds (DeepFM's
  sparse world runs in threads above and on the card): every sound
  scenario bitwise equal to ``ps_check.replay``, the sparse bytes as
  counted from the rounds' unique ids, and both planted faults caught.
"""

import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge, launch, ps, ps_check
from paddle_operator_tpu_torch.examples import train_wide_deep_ps
from paddle_operator_tpu_torch.models import deepfm as tfm
from paddle_operator_tpu_torch.models import wide_deep as twd

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from paddle_operator_tpu import ps as jps  # noqa: E402
from paddle_operator_tpu.api import types as api  # noqa: E402
from paddle_operator_tpu.models import deepfm as jfm  # noqa: E402
from paddle_operator_tpu.models import wide_deep as jwd  # noqa: E402
from paddle_operator_tpu.testing import OperatorHarness  # noqa: E402

TINY = dict(num_slots=8, vocab_per_slot=100, embed_dim=8, dense_dim=13,
            hidden=[32, 32])
#: >=100k rows of width embed_dim + 1 (tests/test_ps_mode.py's SPARSE_CFG)
SPARSE_CFG = dict(num_slots=8, vocab_per_slot=20000, embed_dim=8,
                  dense_dim=13, hidden=[16])
MODELS = {"wide_deep": (jwd, twd), "deepfm": (jfm, tfm)}
F32 = torch.float32


def _cfg(worker, n, eps, role="TRAINER"):
    return launch.LaunchConfig(worker_id=worker, num_workers=n, role=role,
                               ps_endpoints=list(eps))


def _run_world(jobs, servers, timeout=180):
    """Run ``jobs[w]`` (a ``(run_ps_training, job)`` pair) as trainer w
    in a thread each against ``servers``; stop the servers after."""
    eps = [s.endpoint for s in servers]
    results, errors = {}, []

    def trainer(w):
        run, job = jobs[w]
        try:
            results[w] = run(job, _cfg(w, len(jobs), eps))
        except Exception as e:  # surfaced in the main thread
            errors.append((w, repr(e)))

    threads = [threading.Thread(target=trainer, args=(w,))
               for w in range(len(jobs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)
        assert not any(t.is_alive() for t in threads), "trainers hung"
        assert not errors, errors
    finally:
        for s in servers:
            s.stop()
    return results


def _servers(n, n_trainers, **kw):
    return [ps.ParamServer(n_trainers=n_trainers, **kw).start()
            for _ in range(n)]


# ---------------------------------------------------------------------------
# the flat vector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dense_only", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_flatten_params_is_the_jax_vector(name, dense_only):
    jm = MODELS[name][0]
    tree = (jm.init_dense if dense_only else jm.init)(
        jax.random.PRNGKey(0), TINY)
    want, _, want_shapes = jps.flatten_params(tree)
    port = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")
    got, struct, shapes = ps.flatten_params(port)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert [s for s, _ in shapes] == [tuple(s) for s, _ in want_shapes]
    back = ps.unflatten_params(got, struct, shapes, "cpu")
    for k, t in bridge.flatten(back).items():
        assert torch.equal(t, bridge.flatten(port)[k]), k
    # the port's own init inserts its keys in the reference's init
    # order, which is not the vector's: the planted fault's layout
    own = MODELS[name][1].init_dense if dense_only else MODELS[name][1].init
    own = own(torch.Generator().manual_seed(0), TINY)
    assert list(ps_check._insertion_order_flatten(own)) != list(
        bridge.flatten(own))
    for dim, n in [(10, 3), (7, 2), (494_625, 2), (4_914_625, 3), (1, 1)]:
        assert ps.shard_ranges(dim, n) == jps.shard_ranges(dim, n)


def test_port_modules_import_with_torch_alone():
    """ps, the CTR models and the examples import with no JAX and no
    module of the JAX package on the path."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['paddle_operator_tpu'] = None\n"
            "import paddle_operator_tpu_torch.ps\n"
            "import paddle_operator_tpu_torch.ps_check\n"
            "import paddle_operator_tpu_torch.models.wide_deep\n"
            "import paddle_operator_tpu_torch.models.deepfm\n"
            "import paddle_operator_tpu_torch.examples.train_wide_deep\n"
            "import paddle_operator_tpu_torch.examples.train_deepfm\n"
            "import paddle_operator_tpu_torch.examples.train_wide_deep_ps\n"
            "assert not [m for m in sys.modules if m.startswith('jax')\n"
            "            and sys.modules[m] is not None]\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 0, out.stderr[-2000:]


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def _drive(client_cls, endpoints, dim=10, rows_dim=3):
    """A fixed conversation of one trainer: init, two dense rounds, two
    sparse rounds. Returns what it pulled."""
    c = client_cls(endpoints, worker_id=0)
    c.init(np.arange(dim, dtype=np.float32) * 0.5)
    vec, version = c.pull(after=0)
    for k in range(2):
        assert c.push(np.full(dim, k + 1.0, np.float32) / 3, version)
        vec, version = c.pull(after=version)
    ids = np.array([4, 1, 9, 4], np.int64)
    sver = 0
    for k in range(2):
        rows, sver = c.sparse_pull(ids[:3], after=sver, dim=rows_dim)
        grads = np.arange(3 * rows_dim, dtype=np.float32).reshape(
            3, rows_dim) * (k + 1) / 7
        assert c.sparse_push(ids[:3], grads, sver)
    rows, sver = c.sparse_pull(ids, after=sver, dim=rows_dim)
    return vec, version, rows, sver, c.bytes_sent, c.bytes_recv


def _server_state(s):
    return (s._vec, s._slot, s.version, s.sparse_version,
            {r: s.sparse.rows[r] for r in sorted(s.sparse.rows)},
            {r: s.sparse.slots[r] for r in sorted(s.sparse.slots)})


def test_servers_and_clients_interoperate_with_jax_bitwise():
    kw = dict(n_trainers=1, lr=0.1, momentum=0.9, sparse_dim=3,
              sparse_seed=5)
    runs = {}
    for server_side in ("port", "jax"):
        for client_side in ("port", "jax"):
            mod = ps if server_side == "port" else jps
            servers = [mod.ParamServer(**kw).start() for _ in range(2)]
            try:
                client = (ps if client_side == "port" else jps).PsClient
                runs[server_side, client_side] = (
                    _drive(client, [s.endpoint for s in servers]),
                    [_server_state(s) for s in servers])
            finally:
                for s in servers:
                    s.stop()
    want_pulled, want_state = runs["jax", "jax"]
    for key, (pulled, state) in runs.items():
        for a, b in zip(pulled, want_pulled):
            np.testing.assert_array_equal(a, b, err_msg=str(key))
        for s, w in zip(state, want_state):
            for a, b in zip(s[:4], w[:4]):
                np.testing.assert_array_equal(a, b, err_msg=str(key))
            for d, dw in zip(s[4:], w[4:]):
                assert list(d) == list(dw), key
                for r in dw:
                    np.testing.assert_array_equal(d[r], dw[r])


def test_snapshots_load_across_the_two_packages(tmp_path):
    for writer, reader in ((ps, jps), (jps, ps)):
        snap = str(tmp_path / writer.__name__)
        srv = writer.ParamServer(n_trainers=1, lr=0.1, momentum=0.9,
                                 sparse_dim=2, sparse_seed=0,
                                 snapshot_dir=snap).start()
        try:
            _drive(writer.PsClient, [srv.endpoint], rows_dim=2)
            want = _server_state(srv)
        finally:
            srv.stop()
        restored = reader.ParamServer(n_trainers=1, lr=0.1, momentum=0.9,
                                      sparse_dim=2, sparse_seed=0,
                                      snapshot_dir=snap)
        got = _server_state(restored)
        restored._httpd.server_close()
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:4] == want[2:4]
        assert list(got[4]) == list(want[4])
        for r in want[4]:
            np.testing.assert_array_equal(got[4][r], want[4][r])
            np.testing.assert_array_equal(got[5][r], want[5][r])
        store = reader.SnapshotStore(os.path.join(snap))
        vec, _, version = store.load_dense()
        np.testing.assert_array_equal(vec, want[0])
        assert version == want[2]


def test_duplicate_push_resend_is_acked_not_stale():
    srv = ps.ParamServer(n_trainers=1, lr=0.1, momentum=0.0,
                         sparse_dim=2, sparse_seed=0).start()
    try:
        c = ps.PsClient([srv.endpoint], worker_id=0)
        c.init(np.zeros(4, np.float32))
        _, version = c.pull(after=0)
        g = np.ones(4, np.float32)
        assert c.push(g, version) is True
        assert c.push(g, version) is True        # duplicate re-send
        assert srv.version == version + 1        # applied once
        vec, _ = c.pull(after=version)
        np.testing.assert_allclose(vec, -0.1 * g)
        ids = np.array([3], np.int64)
        rows0, sver = c.sparse_pull(ids, after=0, dim=2)
        gr = np.ones((1, 2), np.float32)
        assert c.sparse_push(ids, gr, sver) is True
        assert c.sparse_push(ids, gr, sver) is True
        assert srv.sparse_version == sver + 1
        rows1, _ = c.sparse_pull(ids, after=sver, dim=2)
        np.testing.assert_allclose(rows1, rows0 - 0.1 * gr, rtol=1e-6)
        assert c.push(g, version - 1) is False   # a stale round: 409
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# live worlds in threads
# ---------------------------------------------------------------------------

def _tiny_job(name="wide_deep", steps=6, batch=64, device="cpu"):
    tm = MODELS[name][1]
    return ps.PsTrainJob(
        init_params=lambda gen: tm.init(gen, TINY), loss_fn=tm.loss_fn,
        make_batch=lambda gen, step: tm.synthetic_batch(gen, batch, TINY),
        total_steps=steps, lr=0.1, momentum=0.9, device=device)


def test_ps_mode_trains_live_from_operator_env():
    h = OperatorHarness(http_coordination=True)
    spec = lambda n: {"replicas": n, "template": {"spec": {  # noqa: E731
        "containers": [{"name": "c", "image": "x"}]}}}
    h.create_job(api.new_tpujob("wd", spec={"ps": spec(2),
                                            "worker": spec(2)}))
    h.converge()
    job = h.get_job("wd")
    assert job.phase == api.Phase.RUNNING and job.status["mode"] == "PS"
    cm = h.client.get("ConfigMap", "default", "wd")["data"]
    assert len(cm["PADDLE_PSERVERS_IP_PORT_LIST"].split(",")) == 2
    h.close()

    servers = _servers(2, 2, lr=0.1, momentum=0.9)
    endpoints = ",".join(s.endpoint for s in servers)
    cfgs = []
    for w in (0, 1):
        env = dict(cm, PADDLE_PSERVERS_IP_PORT_LIST=endpoints,
                   TRAINING_ROLE="TRAINER", PADDLE_TRAINER_ID=str(w))
        cfg = launch.detect_env(env)
        assert (cfg.role, cfg.worker_id, cfg.num_workers) == ("TRAINER", w, 2)
        assert cfg.ps_endpoints == endpoints.split(",")
        cfgs.append(cfg)
    job = _tiny_job()
    results, errors = {}, []

    def trainer(w):
        try:
            results[w] = ps.run_ps_training(job, cfgs[w])
        except Exception as e:
            errors.append((w, repr(e)))

    threads = [threading.Thread(target=trainer, args=(w,)) for w in (0, 1)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads), "trainers hung"
        assert not errors, errors
        for s in servers:   # the done protocol: every trainer posted /done
            s._thread.join(timeout=10)
            assert not s._thread.is_alive(), "pserver kept serving"
    finally:
        for s in servers:
            s.stop()
    v0 = ps.flatten_params(results[0]["params"])[0]
    v1 = ps.flatten_params(results[1]["params"])[0]
    np.testing.assert_array_equal(v0, v1)
    for r in results.values():
        assert len(r["losses"]) == 6 and all(np.isfinite(r["losses"]))
    first = np.mean([results[w]["losses"][0] for w in (0, 1)])
    last = np.mean([results[w]["losses"][-1] for w in (0, 1)])
    assert last < first, (first, last)


def test_run_ps_training_roles_and_devices():
    """PSERVER serves the advertised endpoint and never initialises
    CUDA; a trainer refuses to run without a card unless given the
    CPU, before it contacts a server."""
    srv = ps.ParamServer(n_trainers=1)
    cfg = _cfg(0, 1, ["127.0.0.1:0"], role="PSERVER")
    t = threading.Thread(target=ps.run_ps_training, daemon=True,
                         args=(ps.PsTrainJob(None, None, None), cfg),
                         kwargs={"server": srv})
    t.start()
    with urllib.request.urlopen("http://%s/meta" % srv.endpoint,
                                timeout=5) as resp:
        assert b"n_trainers" in resp.read()
    ps.PsClient([srv.endpoint], 0).shutdown_servers()
    t.join(timeout=10)
    assert not t.is_alive()
    srv.stop()
    assert not torch.cuda.is_initialized()
    job = _tiny_job(device=None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ps.run_ps_training(job, _cfg(0, 1, ["127.0.0.1:9"]))


# batches and init shared by the JAX and port trainers: looked up by the
# generator each side hands make_batch (the port's step_generator seed,
# JAX's folded key)
def _shared_world(name, steps=4, batch=32):
    jm, tm = MODELS[name]
    tree = jax.tree_util.tree_map(np.asarray,
                                  jm.init(jax.random.PRNGKey(0), TINY))
    rng = np.random.default_rng(11)
    batches = {}
    for w in (0, 1):
        for s in range(steps):
            b = {"sparse": rng.integers(0, 100, (batch, 8)).astype(np.int64),
                 "dense": rng.standard_normal((batch, 13)).astype(np.float32),
                 "label": rng.integers(0, 2, (batch,)).astype(np.int32)}
            port_key = ps.batch_generator(w, s, "cpu").initial_seed()
            jax_key = np.asarray(jax.random.fold_in(
                jax.random.PRNGKey(1000 + w), s)).tobytes()
            batches[port_key] = batches[jax_key] = b
    port_job = ps.PsTrainJob(
        init_params=lambda gen: bridge.params_from_numpy(tree, "cpu"),
        loss_fn=lambda p, b: tm.loss_fn(p, b, dtype=F32),
        make_batch=lambda gen, s: {k: torch.from_numpy(v) for k, v in
                                   batches[gen.initial_seed()].items()},
        total_steps=steps, device="cpu")
    jax_job = jps.PsTrainJob(
        init_params=lambda key: jax.tree_util.tree_map(jnp.asarray, tree),
        loss_fn=lambda p, b: jm.loss_fn(p, b, dtype=jnp.float32),
        make_batch=lambda key, s: jax.tree_util.tree_map(
            jnp.asarray, batches[np.asarray(key).tobytes()]),
        total_steps=steps)
    return port_job, jax_job


@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_trainers_reach_the_port_trainers_vector(name):
    port_job, jax_job = _shared_world(name)
    final = {}
    for label, jobs in (
            ("port", [(ps.run_ps_training, port_job)] * 2),
            ("jax", [(jps.run_ps_training, jax_job)] * 2),
            ("mixed", [(jps.run_ps_training, jax_job),
                       (ps.run_ps_training, port_job)])):
        res = _run_world(jobs, _servers(2, 2, lr=0.1, momentum=0.9))
        vecs = [(ps if isinstance(bridge.leaves(res[w]["params"])[0],
                                  torch.Tensor) else jps)
                .flatten_params(res[w]["params"])[0] for w in (0, 1)]
        np.testing.assert_array_equal(vecs[0], vecs[1])
        final[label] = vecs[0]
    for label in ("jax", "mixed"):
        np.testing.assert_allclose(final[label], final["port"], rtol=0,
                                   atol=1e-5, err_msg=label)


def _sparse_job(name, cfg=SPARSE_CFG, steps=4, batch=32):
    tm = MODELS[name][1]
    return ps.PsTrainJob(
        init_params=lambda gen: tm.init_dense(gen, cfg),
        loss_fn=tm.sparse_loss_fn,
        make_batch=lambda gen, step: tm.synthetic_batch(gen, batch, cfg),
        ids_fn=lambda b: tm.sparse_ids(b, cfg["vocab_per_slot"]),
        embed_dim=tm.sparse_row_dim(cfg), total_steps=steps, lr=0.1,
        momentum=0.9, device="cpu")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_sparse_traffic_scales_with_touched_rows(name):
    """Per-round wire bytes depend on the rows a batch touches, not on
    the table: a 4x larger table moves them by under 5 %, and they stay
    far below the table's size; the trainers of a two-trainer world
    agree bit for bit and their sparse versions advance in lockstep."""
    per_round = {}
    for scale in (1, 4):
        cfg = dict(SPARSE_CFG, vocab_per_slot=20000 * scale)
        job = _sparse_job(name, cfg)
        res = _run_world([(ps.run_ps_training, job)] * 2, _servers(
            2, 2, lr=0.1, momentum=0.9, sparse_dim=job.embed_dim))
        v0 = ps.flatten_params(res[0]["params"])[0]
        np.testing.assert_array_equal(
            v0, ps.flatten_params(res[1]["params"])[0])
        assert res[0]["sparse_version"] == res[1]["sparse_version"] == 4
        table_bytes = 8 * 20000 * scale * job.embed_dim * 4
        per_round[scale] = (res[0]["bytes_sent"] + res[0]["bytes_recv"]) / 4
        assert per_round[scale] < table_bytes / 50
    assert abs(per_round[4] - per_round[1]) / per_round[1] < 0.05


def test_pserver_restart_mid_training_is_bit_transparent(tmp_path):
    """Kill the pserver after round 3 persisted, restart it from its
    snapshot on the same port: the port trainer rides the connection
    retries and stall re-pushes and ends bitwise where an uninterrupted
    run ends."""
    def port_of():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    def run(snap, port, chaos):
        job = _sparse_job("wide_deep", steps=8)
        kw = dict(n_trainers=1, lr=0.1, momentum=0.9,
                  sparse_dim=job.embed_dim, sparse_seed=0, port=port,
                  snapshot_dir=snap)
        servers = [ps.ParamServer(**kw).start()]
        killed = []
        make = job.make_batch

        def make_batch(gen, step):
            if chaos and not killed and servers[0].version >= 3:
                killed.append(step)
                servers[0].stop()
                servers.append(ps.ParamServer(**kw).start())
            return make(gen, step)

        job.make_batch = make_batch
        try:
            res = ps.run_ps_training(
                job, _cfg(0, 1, ["127.0.0.1:%d" % port]))
        finally:
            for s in servers:
                s.stop()
        return res, dict(servers[-1].sparse.rows), killed

    res_c, rows_c, killed = run(str(tmp_path / "snap"), port_of(), True)
    assert killed, "the drill never killed the server"
    res_r, rows_r, _ = run(str(tmp_path / "ref"), port_of(), False)
    np.testing.assert_array_equal(ps.flatten_params(res_c["params"])[0],
                                  ps.flatten_params(res_r["params"])[0])
    assert sorted(rows_c) == sorted(rows_r)
    for r in rows_r:
        np.testing.assert_array_equal(rows_c[r], rows_r[r])
    assert res_c["losses"] == res_r["losses"]


# ---------------------------------------------------------------------------
# one world of processes (ps_check)
# ---------------------------------------------------------------------------

ENV_DENSE = {"TPUJOB_BATCH": "64", "TPUJOB_STEPS": "3", "TPUJOB_LR": "0.1"}
ENV_SPARSE = dict(ENV_DENSE, TPUJOB_SPARSE="1")
SCENARIOS = (
    dict(name="dense_wide_deep", model="wide_deep", env=ENV_DENSE),
    dict(name="sparse_wide_deep", model="wide_deep", env=ENV_SPARSE),
    dict(name="leaf_order", model="wide_deep", env=ENV_DENSE,
         fault="leaf_order"),
    dict(name="stale_rows", model="wide_deep", env=ENV_SPARSE,
         fault="stale_rows", straggle_s=0.2),
    dict(name="straggler", model="wide_deep", env=ENV_SPARSE,
         straggle_s=0.2),
)
SOUND = ("dense_wide_deep", "sparse_wide_deep", "straggler")


@pytest.fixture(scope="module")
def world():
    scenarios = [dict(sc) for sc in SCENARIOS]
    with tempfile.TemporaryDirectory(prefix="ps_world_") as out:
        spec = {"out": out, "device": "cpu", "deterministic": True,
                "scenarios": scenarios}
        t0 = time.perf_counter()
        runs = ps_check.launch_world(spec, timeout=240)
        wall = time.perf_counter() - t0
    replays = {sc["name"]: ps_check.replay(
        ps_check.scenario_job(sc, "cpu"), 2, "cpu") for sc in scenarios}
    return {"runs": runs, "replays": replays, "wall": wall,
            "scenarios": {sc["name"]: sc for sc in scenarios}}


@pytest.mark.parametrize("name", SOUND)
def test_world_is_bitwise_its_replay(world, name):
    run, rep = world["runs"][name], world["replays"][name]
    assert run["pserver_rcs"] == [0, 0]          # the done protocol
    t0, t1 = run["trainers"]
    np.testing.assert_array_equal(t0["vector"], t1["vector"])
    np.testing.assert_array_equal(t0["vector"], rep["vector"])
    for w, t in enumerate(run["trainers"]):
        np.testing.assert_array_equal(t["losses"], rep["losses"][w])
        assert len(t["losses"]) == 3 and np.all(np.isfinite(t["losses"]))


@pytest.mark.parametrize("name", ["sparse_wide_deep", "straggler"])
def test_world_sparse_bytes_are_the_rounds_unique_ids(world, name):
    job = ps_check.scenario_job(world["scenarios"][name], "cpu")
    for t in world["runs"][name]["trainers"]:
        assert len(t["uniques"]) == 3
        assert int(t["bytes_sent"]) == ps_check.expected_bytes_sent(
            len(t["vector"]), t["uniques"], 2, job.embed_dim)
        assert int(t["sparse_version"]) == 3


def test_world_catches_both_planted_faults(world):
    """leaf_order: the trainers agree and follow the replay's losses, but
    their vector is a permutation of the replay's; stale_rows: the
    replay parts from the world."""
    runs, reps = world["runs"], world["replays"]
    leaf = runs["leaf_order"]["trainers"]
    np.testing.assert_array_equal(leaf[0]["vector"], leaf[1]["vector"])
    assert not np.array_equal(leaf[0]["vector"],
                              reps["leaf_order"]["vector"])
    np.testing.assert_array_equal(np.sort(leaf[0]["vector"]),
                                  np.sort(reps["leaf_order"]["vector"]))
    stale = runs["stale_rows"]["trainers"]
    assert not np.array_equal(stale[0]["vector"],
                              reps["stale_rows"]["vector"])
    for name in ("leaf_order", "stale_rows"):
        assert runs[name]["pserver_rcs"] == [0, 0]


def test_ps_example_job_from_env():
    job = train_wide_deep_ps.make_job({})
    assert (job.total_steps, job.lr, job.embed_dim) == (100, 0.1, 0)
    sparse = train_wide_deep_ps.make_job(
        {"TPUJOB_SPARSE": "1", "TPUJOB_LR": "0.05", "TPUJOB_STEPS": "3",
         "TPUJOB_BATCH": "8"})
    assert (sparse.total_steps, sparse.lr, sparse.embed_dim) == (3, 0.05, 17)
    b = sparse.make_batch(torch.Generator().manual_seed(0), 0)
    ids = sparse.ids_fn(b)
    assert ids.dtype == np.int64 and ids.shape == (8 * 26,)
    vec, _, _ = ps.init_vector(sparse, "cpu")
    assert len(vec) == 494_625
    dfm = train_wide_deep_ps.make_job({"TPUJOB_SPARSE": "1"}, model=tfm)
    assert dfm.embed_dim == 17 and dfm.loss_fn is tfm.sparse_loss_fn
