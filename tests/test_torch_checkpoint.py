"""The torch port's checkpoints, input pipeline, launch config and runner.

* checkpoints: a v2 step written by the port restores in the JAX
  package's ``restore_checkpoint`` and one written by the JAX package
  restores in the port, with the same flat names, CRC32s and COMMIT
  marker, bit for bit; torn steps are skipped and quarantined;
* the runner on the CPU (ResNet-18, 16x16, batch 4, fp32): a run that
  stops at a checkpoint and resumes gives the uninterrupted run's losses
  bit for bit (the CPU kernels are deterministic), as does a run on
  ``[2, ...]`` windows; a drain request checkpoints and stops.
"""

import json
import os

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge, data, launch
from paddle_operator_tpu_torch.models import resnet as tres
from paddle_operator_tpu_torch.ops import optim as topt
from paddle_operator_tpu_torch.runner import DrainMonitor, TrainJob, \
    run_training
from paddle_operator_tpu_torch.utils import checkpoint as tckpt


def _state(seed=0):
    """A train-state-shaped tree: params, int32 step, momentum."""
    rng = np.random.default_rng(seed)
    params = {"stages": [[{"conv": {"kernel": rng.standard_normal(
        (3, 3, 2, 4), dtype=np.float32)}}]],
        "head": {"fc": {"kernel": rng.standard_normal((4, 3), np.float32),
                        "bias": np.zeros(3, np.float32)}}}
    return {"params": params,
            "opt": {"step": np.asarray(7, np.int32),
                    "momentum": bridge.tree_map(np.ones_like, params)}}


def _same(a, b):
    fa, fb = bridge.flatten(a), bridge.flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


# ---------------------------------------------------------------------------
# checkpoints, both ways
# ---------------------------------------------------------------------------

def test_port_checkpoint_restores_in_jax(tmp_path):
    from paddle_operator_tpu.utils import checkpoint as jckpt

    state = _state()
    live = bridge.params_from_numpy(state, device="cpu")
    tckpt.save_checkpoint(str(tmp_path), 7, live, meta={"epoch": 0})
    got, manifest = jckpt.restore_checkpoint(str(tmp_path))
    _same(state, got)
    assert manifest["commit"] == jckpt.COMMIT_MARKER
    assert manifest["format_version"] == jckpt.FORMAT_VERSION == 2
    assert manifest["checksums"] == {
        k: jckpt._leaf_crc(v) for k, v in jckpt._flatten(state).items()}
    assert jckpt.latest_step(str(tmp_path)) == 7


def test_jax_checkpoint_restores_in_port(tmp_path):
    from paddle_operator_tpu.utils import checkpoint as jckpt

    state = _state(1)
    jckpt.save_checkpoint(str(tmp_path), 5, state, meta={"epoch": 2})
    got, manifest = tckpt.restore_latest(str(tmp_path))
    _same(state, got)
    assert manifest["step"] == 5 and manifest["meta"] == {"epoch": 2}
    live = bridge.params_from_numpy(_state(2), device="cpu")
    tckpt.load_into(live, got)
    _same(state, bridge.params_to_numpy(live))
    with open(os.path.join(str(tmp_path), "step_%012d" % 5,
                           "manifest.json")) as f:
        raw = json.load(f)
    port_dir = tmp_path / "port"
    tckpt.save_checkpoint(str(port_dir), 5, live, meta={"epoch": 2})
    with open(os.path.join(str(port_dir), "step_%012d" % 5,
                           "manifest.json")) as f:
        assert json.load(f) == raw      # byte-for-byte the same manifest


def test_load_into_refuses_a_mismatched_tree():
    live = bridge.params_from_numpy(_state(), device="cpu")
    other = _state()
    other["params"]["head"]["fc"]["bias"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError):
        tckpt.load_into(live, other)
    del other["params"]["head"]
    with pytest.raises(ValueError):
        tckpt.load_into(live, other)


@pytest.mark.parametrize("damage", ["npz_bytes", "uncommitted",
                                    "torn_manifest"])
def test_torn_step_is_quarantined(tmp_path, damage):
    d = str(tmp_path)
    tckpt.save_checkpoint(d, 1, _state(1))
    tckpt.save_checkpoint(d, 2, _state(2))
    step2 = os.path.join(d, "step_%012d" % 2)
    if damage == "npz_bytes":
        path = os.path.join(step2, "state.npz")
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(path, "wb").write(bytes(raw))
    else:
        path = os.path.join(step2, "manifest.json")
        manifest = json.load(open(path))
        if damage == "uncommitted":
            del manifest["commit"]
            json.dump(manifest, open(path, "w"))
        else:
            open(path, "w").write(json.dumps(manifest)[:40])
        assert tckpt.latest_step(d) == 1
    got, manifest = tckpt.restore_latest(d)
    assert manifest["step"] == 1
    _same(_state(1), got)
    assert os.path.isdir(step2 + ".corrupt")
    assert not os.path.exists(step2)
    with pytest.raises(tckpt.CorruptCheckpointError):
        tckpt.restore_checkpoint(d, step=1, _manifest=dict(
            manifest, checksums={"params/head/fc/bias": 1}))


def test_gc_keeps_the_newest_steps(tmp_path):
    d = str(tmp_path)
    for step in range(1, 6):
        tckpt.save_checkpoint(d, step, _state(), keep=2)
    assert tckpt.all_steps(d) == [4, 5]
    with pytest.raises(FileNotFoundError):
        tckpt.restore_latest(str(tmp_path / "empty"))


def test_async_checkpointer_snapshots_and_surfaces_errors(tmp_path):
    live = bridge.params_from_numpy(_state(), device="cpu")
    w = tckpt.AsyncCheckpointer()
    w.save(str(tmp_path), 3, live)
    live["params"]["head"]["fc"]["bias"].add_(1.0)   # after the snapshot
    w.save(str(tmp_path), 4, live)
    w.wait()
    got, _ = tckpt.restore_checkpoint(str(tmp_path), 3)
    _same(_state(), got)
    got, _ = tckpt.restore_checkpoint(str(tmp_path), 4)
    assert np.array_equal(got["params"]["head"]["fc"]["bias"],
                          np.ones(3, np.float32))
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    w.save(str(blocker), 5, live)
    with pytest.raises(OSError):
        w.wait()
    w.wait()                            # the error was reported once


# ---------------------------------------------------------------------------
# input pipeline and launch config
# ---------------------------------------------------------------------------

def test_step_generator_is_a_function_of_seed_and_step():
    def gen(seed, step):
        return data.step_generator(seed, step, device="cpu")

    a = torch.rand(4, generator=gen(0, 5))
    assert torch.equal(a, torch.rand(4, generator=gen(0, 5)))
    assert not torch.equal(a, torch.rand(4, generator=gen(0, 6)))
    assert not torch.equal(a, torch.rand(4, generator=gen(1, 5)))


@pytest.mark.parametrize("K,shapes,steps", [
    (1, [(2,)] * 7, [[s] for s in range(1, 8)]),
    (3, [(3, 2), (3, 2), (2,)], [[1, 2, 3], [4, 5, 6], [7]]),
])
def test_loader_windows_tail_and_order(K, shapes, steps):
    def make(gen, step):
        return {"x": torch.full((2,), float(step)),
                "r": torch.rand(1, generator=gen)}

    src = data.job_window_source(make, 0, 1, 8, steps_per_call=K,
                                 device="cpu")
    with data.ShardedLoader(src, device="cpu") as loader:
        got = list(loader)
    assert [tuple(b["x"].shape) for b in got] == shapes
    assert [b["x"][..., 0].flatten().tolist() for b in got] == steps
    again = make(data.step_generator(0, 7, device="cpu"), 7)["r"]
    assert torch.equal(got[-1]["r"], again)   # same (seed, step) batch


def test_loader_reraises_source_errors_and_closes():
    def source():
        yield {"x": np.zeros(2)}
        raise KeyError("boom")

    loader = data.ShardedLoader(source(), device="cpu")
    first = next(loader)
    assert isinstance(first["x"], torch.Tensor)
    with pytest.raises(KeyError):
        next(loader)
    loader.close()
    assert not loader.producer_alive()
    empty = data.ShardedLoader(iter(()), device="cpu")
    with pytest.raises(StopIteration):
        next(empty)
    empty.close()
    assert not empty.producer_alive()


def test_loader_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        data.ShardedLoader(iter(()))
    with pytest.raises(RuntimeError, match="cuda"):
        data.step_generator(0, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        data.job_window_source(lambda gen, step: step, 0, 0, 2)


def test_deferred_metrics_resolve_previous_boundary():
    dm = data.DeferredMetrics()
    assert dm.start(1, {"loss": torch.tensor(2.0)}) is None
    step, _, host = dm.start(2, {"loss": torch.tensor(3.0)})
    assert step == 1 and float(host["loss"]) == 2.0
    step, _, host = dm.resolve()
    assert step == 2 and isinstance(host["loss"], np.ndarray)
    assert dm.resolve() is None


@pytest.mark.parametrize("env", [
    {},
    {"TPU_WORKER_ID": "2", "TPU_WORKER_HOSTNAMES": "a,b,c,d"},
    {"PADDLE_TRAINER_ID": "1", "PADDLE_TRAINERS_NUM": "2",
     "PADDLE_TRAINER_ENDPOINTS": "h0:1,h1:1", "PADDLE_PORT": "9"},
    {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "a,b",
     "MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1",
     "MEGASCALE_COORDINATOR_ADDRESS": "m0:8080"},
])
def test_detect_env_matches_jax(env):
    from paddle_operator_tpu import launch as jlaunch

    want = jlaunch.detect_env(dict(env))
    got = launch.detect_env(dict(env))
    assert got.__dict__ == {k: getattr(want, k) for k in got.__dict__}
    assert (got.is_distributed, got.is_elastic) == (
        want.is_distributed, want.is_elastic)


def test_initialize_distributed_single_process_only():
    launch.initialize_distributed(launch.LaunchConfig())
    with pytest.raises(NotImplementedError):
        launch.initialize_distributed(launch.LaunchConfig(num_workers=2))


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _job(losses, total, ckpt_dir="", **kw):
    def loss_fn(params, batch):
        loss, aux = tres.loss_fn(params, batch, dtype=torch.float32)
        losses.append(loss.item())
        return loss, aux

    return TrainJob(
        init_params=lambda gen: tres.init(gen, depth=18, num_classes=10),
        loss_fn=loss_fn,
        optimizer=topt.fused_sgd(topt.cosine_schedule(0.05, 6, 1),
                                 momentum=0.9, weight_decay=1e-4),
        make_batch=lambda gen, step: tres.synthetic_batch(gen, 4, 16, 10),
        merge_stats=tres.merge_stats, total_steps=total, log_every=2,
        checkpoint_every=3, checkpoint_dir=ckpt_dir, device="cpu", **kw)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """An uninterrupted 6-step run: losses and the run's result."""
    losses = []
    out = run_training(_job(losses, 6, str(tmp_path_factory.mktemp("a"))))
    return losses, out


def test_runner_trains_and_checkpoints(straight, tmp_path):
    losses, out = straight
    assert out["steps"] == 6 and out["cycles"] == 1 and len(losses) == 6
    assert out["loss"] == losses[-1]
    assert int(out["state"]["opt"]["step"]) == 6
    assert "step_dispatch" in out["host_stages"]
    assert "resume_steps" not in out and "drained" not in out


def test_runner_resume_reproduces_the_uninterrupted_run(straight, tmp_path):
    d = str(tmp_path)
    first = []
    run_training(_job(first, 3, d))
    assert tckpt.latest_step(d) == 3
    second = []
    out = run_training(_job(second, 6, d))
    assert out["resume_steps"] == [3] and len(second) == 3
    assert first + second == straight[0]
    assert tckpt.latest_step(d) == 6


def test_runner_windows_match_single_steps(straight):
    losses = []
    out = run_training(_job(losses, 6, steps_per_call=4))
    assert out["steps"] == 6
    assert losses == straight[0]        # one [4, ...] window + 2 tail steps


def test_drain_request_checkpoints_and_stops(tmp_path):
    monitor = DrainMonitor()
    losses = []
    job = _job(losses, 6, str(tmp_path), drain_monitor=monitor)
    inner = job.loss_fn

    def loss_fn(params, batch):
        if len(losses) == 1:
            monitor.request()           # lands during step 2
        return inner(params, batch)

    job.loss_fn = loss_fn
    out = run_training(job)
    assert out["drained"] and out["drain_step"] == 2 and out["steps"] == 2
    assert tckpt.latest_step(str(tmp_path)) == 2
    assert len(losses) == 2


def test_drain_file_channel(tmp_path):
    flag = tmp_path / "drain"
    monitor = DrainMonitor(str(flag))
    assert not monitor.requested()
    flag.write_text("")
    assert monitor.requested()


def test_runner_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = _job([], 1)
    job.device = None
    with pytest.raises(RuntimeError, match="cuda"):
        run_training(job)


def test_train_resnet_entry_keeps_plain_sgd(monkeypatch):
    monkeypatch.setenv("TPUJOB_STEPS", "40")
    monkeypatch.setenv("TPUJOB_STEPS_PER_CALL", "2")
    monkeypatch.setenv("TPUJOB_CHECKPOINT_DIR", "/ckpt")
    import importlib

    from paddle_operator_tpu_torch.examples import train_resnet

    mod = importlib.reload(train_resnet)
    job = mod.make_job()
    assert (job.total_steps, job.steps_per_call, job.checkpoint_dir) == (
        40, 2, "/ckpt")
    assert job.device is None and job.merge_stats is tres.merge_stats
    params = {"w": torch.ones(3)}
    state = job.optimizer.init(params)
    before = topt.multi_tensor_sgd.launches
    job.optimizer.update({"w": torch.ones(3)}, state, params)
    assert topt.multi_tensor_sgd.launches == before
    # lr at step 1 of cosine_schedule(0.4, 40, 2): warmup 1/2 of 0.4;
    # decay 1e-4 coupled into the grad of 1
    assert torch.allclose(params["w"], torch.full((3,), 1 - 0.2 * 1.0001))
