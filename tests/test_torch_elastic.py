"""Elastic training cycles of the torch port against the JAX package's.

The port copies the membership store, server and keys
(``paddle_operator_tpu_torch/elastic/``), and ports ``ElasticAgent`` and
the runner's restart cycles; each cycle forms a new ``torch.distributed``
world of the epoch's ``np`` ranks (``launch.ElasticWorld``). The JAX side
is the reference's own ``run_training`` under its ``ElasticAgent``,
driven as ``tests/test_elastic_e2e.py`` drives it (one process, its mesh
over the conftest's CPU devices). Both start from one JAX-initialised GPT
tree (``TINY_CONFIG``), carried across as numpy, and train in fp32 on the
global batches of ``elastic_check.numpy_batch(seed, step)``.

* restart at world 1, in process, the epoch bumped at step 3 of 6: the
  per-step losses and the final parameters within tolerance of the
  reference's elastic run, and bitwise equal to the port's uninterrupted
  run;
* shrink: four gloo workers (``python -m paddle_operator_tpu_torch.launch``
  with the elastic env), np 4 -> 2 once step 4 is on disk: ranks 0 and 1
  train on ``{"dp": 4}`` then ``{"dp": 2}``, ranks 2 and 3 save with
  them and leave, and the losses and final parameters are within
  tolerance of the reference's shrink run (``tests/test_elastic_e2e.py:65``'s job);
* grow: np 2 -> 4 with the epoch moved twice back to back and two ranks
  started at the last epoch, which restore the step the first two
  saved; the four replicas agree;
* drain over restart: a drain on rank 1 at the boundary where rank 0
  sees the epoch move; every rank drains.

The three worker worlds run at once, beside the JAX runs. Tolerance:
``tests/test_torch_dp.py``'s GPT fp32 classes, losses within 2e-5
relative and parameters within 1e-4 (``STATE_TOL`` says why).
"""

import concurrent.futures
import os
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge, dp_check, launch
from paddle_operator_tpu_torch import elastic_check as ec
from paddle_operator_tpu_torch.elastic import HttpKVStore, JobRef, \
    MemoryKVStore, bump_epoch, epoch_key, np_key
from paddle_operator_tpu_torch.elastic.server import MembershipServer
from paddle_operator_tpu_torch.elastic.store import connect
from paddle_operator_tpu_torch.runner import _cycle_mesh, run_training
from paddle_operator_tpu_torch.utils import checkpoint as tckpt

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from paddle_operator_tpu import launch as jlaunch  # noqa: E402
from paddle_operator_tpu import runner as jrunner  # noqa: E402
from paddle_operator_tpu.elastic import server as jserver  # noqa: E402
from paddle_operator_tpu.elastic import store as jstore  # noqa: E402
from paddle_operator_tpu.elastic import sync as jsync  # noqa: E402
from paddle_operator_tpu.models import gpt as jgpt  # noqa: E402
from paddle_operator_tpu.ops import optim as jopt  # noqa: E402

#: the losses, relative: the GPT fp32 loss class of the dp path
TOL = 2e-5
#: the parameters, element by element, of max(1, the leaf's largest
#: magnitude): tests/test_torch_dp.py's GPT state class. Adam's
#: m / sqrt(v) amplifies the two packages' rounding where a gradient
#: element is near zero: after 6 steps at lr 1e-3 one element of 16384
#: in layers/1/attn/q/kernel parted by 3.1e-5 while the losses parted by
#: 2.7e-7 at most
STATE_TOL = 1e-4
SEED, BATCH, SEQ = 0, 8, 16
CFG = dict(jgpt.TINY_CONFIG)


def _scenario(tmp, name, steps, **kw):
    return dict(kind="elastic", name=name, job="default-" + name,
                model="gpt_tiny", tree=str(tmp / "tree.npz"), batch=BATCH,
                seq=SEQ, vocab=CFG["vocab_size"], seed=SEED, steps=steps,
                every=2, ckpt_dir=str(tmp / name), save_state=True, **kw)


def _jax_elastic(tree, ckpt_dir, name, steps, np0, bump_at, np1=None):
    """The reference's elastic run of the tiny GPT job: ``np0`` devices,
    the epoch bumped (and ``np`` set to ``np1``) when the producer draws
    step ``bump_at``, as tests/test_elastic_e2e.py does. Returns the
    runner's result and the loss of every step."""
    losses = []

    def loss_fn(p, b):
        loss, aux = jgpt.loss_fn(p, b, dtype=jnp.float32)
        jax.debug.callback(lambda v: losses.append(float(v)), loss)
        return loss, aux

    with jserver.MembershipServer() as srv:
        store = jstore.connect(srv.endpoint)
        store.put(jsync.np_key("default", name), str(np0))
        store.put(jsync.epoch_key("default", name), "1")
        bumped = []

        def make_batch(rng, step):
            if step == bump_at and not bumped:
                bumped.append(step)
                if np1 is not None:
                    store.put(jsync.np_key("default", name), str(np1))
                store.put(jsync.epoch_key("default", name), "2")
            return {"input_ids": jnp.asarray(ec.numpy_batch(
                SEED, step, BATCH, SEQ, CFG["vocab_size"]))}

        job = jrunner.TrainJob(
            init_params=lambda rng: jax.tree_util.tree_map(jnp.asarray,
                                                           tree),
            loss_fn=loss_fn, optimizer=jopt.adamw(1e-3),
            make_batch=make_batch, mesh_axes=lambda world: {"dp": world},
            sharded_checkpoint=np0 > 1, total_steps=steps,
            checkpoint_every=2, checkpoint_dir=ckpt_dir, log_every=0)
        cfg = jlaunch.LaunchConfig(worker_id=0, num_workers=np0,
                                   elastic_server=srv.endpoint,
                                   job_id="default-" + name)
        out = jrunner.run_training(job, cfg=cfg, init_distributed=False,
                                   poll_interval=0.0)
    jax.effects_barrier()
    return out, losses


def _port_restart(tmp, elastic=True):
    """The port's tiny GPT job in this process at world 1: elastic, the
    epoch bumped when the producer draws step 3 (as the reference's
    test), or uninterrupted. Returns the result and each step's loss."""
    losses = []
    job = ec.gpt_tiny_job(_scenario(tmp, "restart", 6))
    inner, draw = job.loss_fn, job.make_batch

    def loss_fn(p, b):
        loss, aux = inner(p, b)
        losses.append(loss.item())
        return loss, aux

    job.loss_fn = loss_fn
    job.checkpoint_every = 2
    job.checkpoint_dir = str(tmp / ("restart" if elastic else "straight"))
    if not elastic:
        return run_training(job, launch.LaunchConfig()), losses
    with MembershipServer() as srv:
        store = connect(srv.endpoint)
        store.put(np_key("default", "restart"), "1")
        store.put(epoch_key("default", "restart"), "1")

        def make_batch(gen, step):
            if step == 3 and store.get(epoch_key("default",
                                                 "restart")) == "1":
                store.put(epoch_key("default", "restart"), "2")
            return draw(gen, step)

        job.make_batch = make_batch
        cfg = launch.LaunchConfig(num_workers=1, job_id="default-restart",
                                  elastic_server=srv.endpoint)
        return run_training(job, cfg, poll_interval=0.0), losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the file: the three worker worlds (shrink, grow,
    drain) at once in threads, the port's in-process restarts and the
    JAX package's elastic runs meanwhile."""
    tmp = tmp_path_factory.mktemp("elastic")
    tree = jax.tree_util.tree_map(
        np.asarray, jgpt.init(jax.random.PRNGKey(0), CFG))
    dp_check.save_tree(str(tmp / "tree.npz"), tree)
    env = {"OMP_NUM_THREADS": "1"}
    # the reference's compile cache would keep the loss callback's
    # executables between runs
    mp = pytest.MonkeyPatch()
    mp.setenv("TPUJOB_COMPILE_CACHE", "0")
    worlds = {
        "shrink": (4, [ec.Trigger("default-shrink", str(tmp / "shrink"), 4,
                                  np=2)],
                   dict(hold_at=4, np=4), 8),
        # two moves back to back: epoch 2, then 3
        "grow": (2, [ec.Trigger("default-grow", str(tmp / "grow"), 2,
                                np=4, joiners=(2, 3), bumps=2)],
                 dict(hold_at=2, np=2), 6),
        "drain": (2, [ec.Trigger("default-drain", str(tmp / "drain"), 2)],
                  dict(hold_at=2, np=2, drain={"rank": 1, "at": 2}), 6)}
    out = {}
    with MembershipServer() as srv, \
            concurrent.futures.ThreadPoolExecutor(len(worlds)) as pool:
        futures = {
            name: pool.submit(
                ec.launch, {"out": str(tmp / ("w_" + name)),
                            "scenarios": [_scenario(tmp, name, steps, **kw)]},
                world, srv.endpoint, triggers, timeout=240, env=env)
            for name, (world, triggers, kw, steps) in worlds.items()}
        out["port_restart"] = _port_restart(tmp)
        out["port_straight"] = _port_restart(tmp, elastic=False)
        out["jax_restart"] = _jax_elastic(tree, str(tmp / "jax_restart"),
                                          "jrestart", 6, 1, 3)
        out["jax_shrink"] = _jax_elastic(tree, str(tmp / "jax_shrink"),
                                         "jshrink", 8, 4, 4, np1=2)
        for name, fut in futures.items():
            out[name] = fut.result()[name]
    mp.undo()
    out["tmp"] = tmp
    return out


def _state(tmp, name, rank):
    return dp_check.load_tree(os.path.join(tmp, "w_" + name,
                                           "%s.rank%d.npz" % (name, rank)))


def _close(got, want):
    """Every leaf, element by element, within STATE_TOL of max(1, its
    largest magnitude)."""
    got, want = bridge.flatten(got), bridge.flatten(want)
    assert sorted(got) == sorted(want)
    for k in want:
        err = np.max(np.abs(np.asarray(got[k], np.float64) - want[k]))
        assert err <= STATE_TOL * max(1.0, np.max(np.abs(want[k]))), (k, err)


def _losses_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g - w) <= TOL * abs(w), (got, want)


# ---------------------------------------------------------------------------
# end to end, against the JAX package
# ---------------------------------------------------------------------------

def test_restart_world1_matches_reference(runs):
    out, losses = runs["port_restart"]
    ref, ref_losses = runs["jax_restart"]
    assert out["cycles"] == ref["cycles"] == 2
    assert out["steps"] == ref["steps"] == 6
    assert out["mesh_history"] == ref["mesh_history"] == [{"dp": 1}] * 2
    assert len(out["resume_steps"]) == 1 and 1 <= out["resume_steps"][0] <= 4
    _losses_close(losses, ref_losses)
    _close(bridge.params_to_numpy(out["state"]["params"]),
           jax.tree_util.tree_map(np.asarray, ref["state"]["params"]))
    # the interrupted run is the uninterrupted one, bit for bit
    straight, straight_losses = runs["port_straight"]
    assert losses == straight_losses
    assert dp_check.digest(out["state"]) == dp_check.digest(
        straight["state"])
    stages = out["cycle_stages"]
    assert [(c["epoch"], c["start_step"], c["end_step"]) for c in stages] \
        == [(1, 0, out["resume_steps"][0]), (2, out["resume_steps"][0], 6)]
    assert "interrupt_save_s" in stages[0]


def test_shrink_np4_to_np2_matches_reference(runs):
    lines = runs["shrink"]
    ref, ref_losses = runs["jax_shrink"]
    stay, gone = lines[:2], lines[2:]
    resume = stay[0]["resume_steps"]
    assert resume == [5]   # the boundary after the held step 4
    for r in stay:
        assert (r["cycles"], r["steps"], r["resume_steps"]) == (2, 8, resume)
        assert r["mesh_history"] == [{"dp": 4}, {"dp": 2}]
    for r in gone:
        assert (r["left_at_epoch"], r["cycles"], r["steps"]) == (2, 2, 5)
        assert r["mesh_history"] == [{"dp": 4}]
    assert ref["mesh_history"] == [{"dp": 4}, {"dp": 2}]
    assert ref["steps"] == 8
    _losses_close(list(ec.step_losses(lines).values()), ref_losses)
    _close(_state(runs["tmp"], "shrink", 0)["params"],
           jax.tree_util.tree_map(np.asarray, ref["state"]["params"]))
    # the replicas agree, and the smaller world starts from the
    # checkpoint the larger one cut
    assert stay[0]["final_digest"] == stay[1]["final_digest"]
    assert [r["prints"][:5] for r in gone] == [stay[0]["prints"][:5]] * 2
    ckpt, manifest = tckpt.restore_checkpoint(
        os.path.join(runs["tmp"], "shrink"), step=5)
    assert manifest["format"] == "sharded" and manifest["meta"]["epoch"] == 1
    want = dp_check.fingerprint(bridge.params_from_numpy(ckpt["params"],
                                                         "cpu")).tolist()
    assert [r["prints"][5] for r in stay] == [want] * 2


def test_grow_np2_to_np4_joiners_restore_the_same_step(runs):
    """The grow moves the epoch twice in quick succession: whatever epoch
    each worker read, all four form the world of the last one."""
    lines = runs["grow"]
    assert [r["rank"] for r in lines] == [0, 1, 2, 3]
    assert [[c["epoch"] for c in r["cycle_stages"]] for r in lines] == \
        [[1, 3]] * 2 + [[3]] * 2
    assert [r["resume_steps"] for r in lines] == [[3]] * 4
    assert [r["mesh_history"] for r in lines] == \
        [[{"dp": 2}, {"dp": 4}]] * 2 + [[{"dp": 4}]] * 2
    assert [(r["cycles"], r["steps"]) for r in lines] == \
        [(2, 6)] * 2 + [(1, 6)] * 2
    assert len({r["final_digest"] for r in lines}) == 1
    # the joiners start from the parameters the first two saved
    assert len({tuple(r["prints"][-3]) for r in lines}) == 1
    assert [len(r["losses"]) for r in lines] == [6, 6, 3, 3]


def test_drain_wins_over_restart_at_one_boundary(runs):
    lines = runs["drain"]
    for r in lines:
        assert (r["drained"], r["drain_step"], r["steps"]) == (True, 3, 3)
        assert (r["cycles"], r["resume_steps"]) == (1, [])
        assert r["mesh_history"] == [{"dp": 2}]
    ckpt = os.path.join(runs["tmp"], "drain")
    assert tckpt.latest_step(ckpt) == 3


# ---------------------------------------------------------------------------
# the copied parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env", [
    {"TPU_WORKER_ID": "0", "TPUJOB_NUM_WORKERS": "4",
     "PADDLE_ELASTIC_JOB_ID": "default-ers",
     "TPUJOB_ELASTIC_SERVER": "http://ms:2379",
     "PADDLE_ELASTIC_TIMEOUT": "30"},
    {"TPUJOB_WORKER_ID": "1", "TPUJOB_NUM_WORKERS": "2",
     "TPUJOB_JOB_ID": "ns-job", "PADDLE_ELASTIC_SERVER": "ms:1"},
])
def test_detect_env_elastic_matches_reference(env):
    got, want = launch.detect_env(dict(env)), jlaunch.detect_env(dict(env))
    assert got.is_elastic and want.is_elastic
    assert got.__dict__ == {k: getattr(want, k) for k in got.__dict__}
    assert (got.job_id, got.elastic_timeout) == (want.job_id,
                                                want.elastic_timeout)


def _agent(store):
    cfg = launch.LaunchConfig(worker_id=0, num_workers=4,
                              job_id="default-ers", elastic_server="mem://")
    return launch.ElasticAgent(cfg, store=store, poll_interval=0.0)


def test_elastic_agent_completes_without_change():
    store = MemoryKVStore()
    store.put(np_key("default", "ers"), "4")
    store.put(epoch_key("default", "ers"), "1")
    seen = []

    def train(world, epoch, should_stop):
        seen.append((world, epoch))
        return True

    assert _agent(store).run(train) == 1
    assert seen == [(4, 1)]
    # no keys: the config's world at epoch 0
    assert _agent(MemoryKVStore()).read_world() == (4, 0)


def test_elastic_agent_restarts_on_epoch_bump():
    store = MemoryKVStore()
    store.put(np_key("default", "ers"), "4")
    store.put(epoch_key("default", "ers"), "1")
    cycles = []

    def train(world, epoch, should_stop):
        cycles.append((world, epoch))
        if len(cycles) == 1:
            assert not should_stop()
            store.put(np_key("default", "ers"), "8")
            store.put(epoch_key("default", "ers"), "2")
            assert should_stop()
            return False
        return True

    assert _agent(store).run(train) == 2
    assert cycles == [(4, 1), (8, 2)]


@pytest.mark.parametrize("job_id", ["ns-job", "a-b-c", "job", ""])
def test_job_ref_reads_the_job_id_as_the_reference_agent(job_id):
    """The agent's keys and the checks' keys come from one parser, which
    splits a job id as the reference's agent does."""
    cfg = dict(num_workers=2, job_id=job_id, elastic_server="mem://")
    want = jlaunch.ElasticAgent(jlaunch.LaunchConfig(**cfg),
                                store=jstore.MemoryKVStore())
    got = launch.ElasticAgent(launch.LaunchConfig(**cfg),
                              store=MemoryKVStore())
    ref = JobRef.of(job_id)
    assert (got._np_key, got._epoch_key) == (want._np_key, want._epoch_key)
    assert (np_key(*ref), epoch_key(*ref)) == (want._np_key,
                                               want._epoch_key)


def test_keys_and_bump_match_reference():
    class Job:
        namespace, name = "ns", "job"

    assert np_key("ns", "job") == jsync.np_key("ns", "job")
    assert epoch_key("ns", "job") == jsync.epoch_key("ns", "job")
    store = MemoryKVStore()
    assert bump_epoch(store, Job()) == "1"
    assert bump_epoch(store, Job()) == "2"
    assert store.get(jsync.epoch_key("ns", "job")) == "2"
    assert store.revision == 2


@pytest.mark.parametrize("server", ["port", "reference"])
def test_http_store_against_live_server(server):
    """The port's HTTP client against a live membership server (the
    port's and the reference's), and the reference's client against the
    port's: get, put, delete, prefix listing, a missing key."""
    make = MembershipServer if server == "port" else jserver.MembershipServer
    with make() as srv:
        for kv in (HttpKVStore(srv.endpoint), connect(srv.endpoint),
                   jstore.HttpKVStore(srv.endpoint)):
            assert kv.get("/tpujob/a/np") is None
            kv.put("/tpujob/a/np", "4")
            kv.put("/tpujob/a/epoch", "1")
            kv.put("/tpujob/b/np", "2")
            assert kv.get("/tpujob/a/np") == "4"
            assert kv.list_prefix("/tpujob/a/") == {
                "/tpujob/a/np": "4", "/tpujob/a/epoch": "1"}
            assert kv.compare_and_put("/tpujob/a/np", "4") is False
            assert kv.compare_and_put("/tpujob/a/np", "8") is True
            kv.delete("/tpujob/a/np")
            assert kv.get("/tpujob/a/np") is None
            kv.delete("/tpujob/a/np")   # a missing key: a no-op
            kv.delete("/tpujob/a/epoch")
            kv.delete("/tpujob/b/np")
            assert kv.endpoints() in ([srv.endpoint],
                                      [srv.endpoint.rstrip("/")])


def test_membership_server_404_and_health():
    import json
    import urllib.error
    import urllib.request

    with MembershipServer() as srv:
        with urllib.request.urlopen(srv.endpoint + "/healthz") as r:
            assert json.loads(r.read()) == {"ok": True}
        for path in ("/v1/kv?key=/none", "/other"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(srv.endpoint + path)
            assert e.value.code == 404
        req = urllib.request.Request(srv.endpoint + "/v1/kv", data=b"{}",
                                     method="PUT")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 400


def _small_state(v):
    return {"params": {"w": torch.full((2, 3), float(v))},
            "opt": {"step": torch.tensor(v, dtype=torch.int32)}}


def test_async_dedup_and_sync_dedup(tmp_path):
    """A second save of the accepted step is a no-op; after a restore
    below it (the step was quarantined) the save is real again, after one
    onto it the dedup holds (tests/test_recovery.py:257)."""
    writer = tckpt.AsyncCheckpointer()
    writer.save(str(tmp_path), 8, _small_state(8))
    writer.save(str(tmp_path), 8, _small_state(9))
    writer.wait()
    restored, _ = tckpt.restore_checkpoint(str(tmp_path), step=8)
    assert int(restored["opt"]["step"]) == 8
    writer.sync_dedup(str(tmp_path), 4)
    writer.save(str(tmp_path), 8, _small_state(88))
    writer.wait()
    restored, _ = tckpt.restore_checkpoint(str(tmp_path), step=8)
    assert int(restored["opt"]["step"]) == 88
    writer.sync_dedup(str(tmp_path), 8)
    writer.save(str(tmp_path), 8, _small_state(0))
    writer.wait()
    restored, _ = tckpt.restore_checkpoint(str(tmp_path), step=8)
    assert int(restored["opt"]["step"]) == 88


def test_async_failed_write_clears_the_dedup(tmp_path):
    target = tmp_path / "ckpt"
    target.write_text("a file where the checkpoint directory should go")
    writer = tckpt.AsyncCheckpointer()
    writer.save(str(target), 1, _small_state(1))
    with pytest.raises(Exception):
        writer.save(str(target), 1, _small_state(1))
    os.remove(str(target))
    writer.save(str(target), 1, _small_state(1))   # a real save
    writer.wait()
    assert tckpt.all_steps(str(target)) == [1]


def test_cycle_mesh_refuses_inferred_sizes_when_elastic():
    with pytest.raises(ValueError, match="fully specified"):
        _cycle_mesh({"dp": -1}, elastic=True)
    assert _cycle_mesh({"dp": -1}).shape == {"dp": 1}
    assert _cycle_mesh({"dp": 1}, elastic=True).shape == {"dp": 1}
    assert _cycle_mesh(None) is None


def test_launch_main_forms_no_group_for_an_elastic_job(tmp_path,
                                                       monkeypatch):
    """An elastic job's runner forms its group at every cycle, so the
    in-pod entry forms none (a two-worker env would wait for the second
    worker)."""
    script = tmp_path / "probe.py"
    script.write_text(textwrap.dedent("""
        import sys, torch.distributed as dist
        open(sys.argv[1], "w").write(str(dist.is_initialized()))
    """))
    monkeypatch.setenv("TPUJOB_NUM_WORKERS", "2")
    monkeypatch.setenv("TPUJOB_WORKER_ID", "0")
    monkeypatch.setenv("TPUJOB_COORDINATOR", "localhost:%d"
                       % dp_check.free_port())
    monkeypatch.setenv("TPUJOB_ELASTIC_SERVER", "http://localhost:1")
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    assert launch.main([str(script), str(tmp_path / "seen")]) == 0
    assert (tmp_path / "seen").read_text() == "False"


def _worlds(ranks, timeout):
    port = dp_check.free_port()
    return [launch.ElasticWorld(launch.LaunchConfig(
        worker_id=r, num_workers=len(ranks), elastic_timeout=timeout,
        coordinator="localhost:%d" % port)) for r in ranks]


def test_elastic_world_agrees_on_the_epoch_after_two_quick_moves():
    """The operator moved the epoch twice in quick succession: worker 0
    read the world between the moves (np 2, epoch 2), workers 1 and 2
    after both (np 2, epoch 3). Worker 0 finds epoch 2 moved and joins
    the others at 3; worker 2, outside the world, takes epoch 3 once it
    has formed. Forming groups under what each read would leave the two
    members waiting under different prefixes."""
    kv = MemoryKVStore()
    kv.put(np_key("default", "quick"), "2")
    kv.put(epoch_key("default", "quick"), "3")
    agent = launch.ElasticAgent(launch.LaunchConfig(
        num_workers=3, job_id="default-quick", elastic_server="mem://"),
        store=kv)
    reads = [(2, 2), (2, 3), (2, 3)]
    worlds = _worlds(range(3), timeout=60.0)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = [pool.submit(w.agree, *read, agent.read_world)
                   for w, read in zip(worlds, reads)]
        assert [f.result(timeout=90) for f in futures] == [(2, 3)] * 3


def test_elastic_world_agreement_times_out():
    """A world whose second worker never checks in: the agreement gives
    up after ``elastic_timeout`` and names the epoch."""
    kv = MemoryKVStore()
    agent = launch.ElasticAgent(launch.LaunchConfig(
        num_workers=2, job_id="default-alone", elastic_server="mem://"),
        store=kv)
    world, = _worlds([0], timeout=0.5)
    with pytest.raises(TimeoutError, match="epoch 4's world of 2"):
        world.agree(2, 4, lambda: (2, 4))


def test_launch_workers_fails_at_once_while_during_runs(tmp_path):
    """A rank that fails while the parent's ``during`` still waits fails
    the world with that rank's errors, before ``during`` returns."""
    script = tmp_path / "fail.py"
    script.write_text("raise SystemExit('rank failed on purpose')\n")
    release = threading.Event()
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="failed on purpose"):
            dp_check.launch_workers(
                {"out": str(tmp_path / "out")}, world=1, timeout=120,
                script=str(script),
                during=lambda start: release.wait(120))
        assert not release.is_set() and time.monotonic() - t0 < 60
    finally:
        release.set()


def test_elastic_world_refuses_a_rank_outside_it():
    world = launch.ElasticWorld(launch.LaunchConfig(worker_id=3,
                                                    coordinator="h:1"))
    assert world.join(1, 1) is False      # a world of one forms no group
    with pytest.raises(ValueError, match="not a rank"):
        world.join(2, 1)



def test_init_distributed_false_keeps_the_callers_group(tmp_path,
                                                        monkeypatch):
    """With ``init_distributed=False`` the caller's process group serves
    the cycles and outlives the run; an elastic world refuses to form a
    group while one is up, since each cycle forms its own."""
    import functools

    import torch.distributed as dist

    from paddle_operator_tpu_torch import runner

    tree = jax.tree_util.tree_map(
        np.asarray, jgpt.init(jax.random.PRNGKey(0), CFG))
    dp_check.save_tree(str(tmp_path / "tree.npz"), tree)
    store = MemoryKVStore()
    store.put(np_key("default", "own"), "1")
    monkeypatch.setattr(runner, "ElasticAgent", functools.partial(
        launch.ElasticAgent, store=store))
    cfg = launch.LaunchConfig(job_id="default-own", elastic_server="mem://")
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        out = run_training(ec.gpt_tiny_job(_scenario(tmp_path, "own", 2)),
                           cfg, init_distributed=False)
        assert dist.is_initialized()
        assert (out["cycles"], out["steps"]) == (1, 2)
        assert out["mesh_history"] == [{"dp": 1}]
        with pytest.raises(RuntimeError, match="already up"):
            launch.ElasticWorld(launch.LaunchConfig(
                coordinator="localhost:1")).join(2, 1)
    finally:
        dist.destroy_process_group()
