"""Data-parallel training of the torch port across two real worker
processes (``python -m paddle_operator_tpu_torch.launch`` with the
operator's env, gloo on the CPU) against the JAX package's dp mesh
(``make_mesh({"dp": 2}, devices[:2])`` on the conftest's CPU devices).

One world of two workers (``paddle_operator_tpu_torch/dp_check.py``) runs
every scenario of this file in turn, so the file pays for one start-up;
each test reads its scenario's results. In fp32:

* ResNet-18 (10 classes, 32x32, global batch 16, SGD with momentum and
  weight decay, ``merge_stats``): three ``build_train_step`` calls, each
  started from JAX's state before it (``tests/test_torch_train.py`` says
  why), against JAX's dp=2 step and against one port process: losses,
  and the whole state after each call (params with BatchNorm's running
  stats, momentum), within rtol/atol 1e-4 (the class of
  ``tests/test_torch_train.py``); plain, ``accum_steps=2`` and
  ``steps_per_call=2`` (which pin the batch axis of the split), and
  ``host_local_batches=True``, which must equal the plain run bit for
  bit. Two planted faults (a local BatchNorm, and rank 1 keeping its
  local gradients) must fail the same comparison.
* sync ``batchnorm`` alone: a batch of 8 split over the two ranks gives
  the one-process forward, input gradients and (summed over the ranks)
  parameter gradients within 1e-5.
* GPT (2 layers, 128 wide, adamw, ``grad_clip=1.0``), dp=2 against JAX's
  dp=2 mesh: losses within 1e-5 relative (``tests/test_torch_gpt_train.py``).
* ``run_training`` with a drain on rank 1 only: both ranks stop at the
  same step and write one sharded step, which the JAX package and the
  port restore, and which the two-worker world resumes from; a sharded
  step written by the JAX package restores in the port.
"""

import concurrent.futures
import functools
import json
import os

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge, dp_check
from paddle_operator_tpu_torch.data import job_window_source, \
    process_shard, stack_window
from paddle_operator_tpu_torch.models import gpt as tgpt
from paddle_operator_tpu_torch.models import resnet as tres
from paddle_operator_tpu_torch.parallel import build_train_step, collectives
from paddle_operator_tpu_torch.parallel.mesh import make_mesh, \
    mesh_from_env
from paddle_operator_tpu_torch.utils import checkpoint as tckpt

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from paddle_operator_tpu import data as jdata  # noqa: E402
from paddle_operator_tpu.models import gpt as jgpt  # noqa: E402
from paddle_operator_tpu.models import resnet as jres  # noqa: E402
from paddle_operator_tpu.ops import optim as jopt  # noqa: E402
from paddle_operator_tpu.parallel import mesh as jmesh  # noqa: E402
from paddle_operator_tpu.parallel import train as jtrain  # noqa: E402
from paddle_operator_tpu.utils import checkpoint as jckpt  # noqa: E402

CALLS = 3
TOL = 1e-4
#: the gradient-borne state (parameter updates and momentum) against the
#: reference's, relative to its norm. A gradient jumps where a ReLU input
#: or a max-pool tie crosses zero, and each side's rounding may move one
#: across (1e-6 relative noise on one call's images moved one port
#: process's momentum by 0.09): two of the nine ResNet calls part by
#: 2.4e-3 and 3.5e-3 so, the others by 4e-6 to 9e-6; the planted fault
#: keeping rank 1's local gradients parts by 1.45
GRAD_RTOL = 1e-2
GPT_CFG = dict(jgpt.TINY_CONFIG)        # 2 layers, 128 wide
GPT_SEQ, GPT_BATCH = 64, 4
#: the ResNet cases: build_train_step arguments of both sides
CASES = {"plain": {}, "accum": {"accum_steps": 2},
         "window": {"steps_per_call": 2}}
FAULT_CASES = {"fault_" + f: f for f in dp_check.FAULTS}


def _resnet_calls(case, seed=1):
    """The numpy batches of each call: global batch 16; for accum two
    microbatches of 16; for window a [2, ...] window then a tail batch."""
    rng = np.random.default_rng(seed)
    n = 32 if case == "accum" else 16
    steps = []
    for _ in range(CALLS):
        b = {"image": rng.standard_normal((n, 32, 32, 3), dtype=np.float32),
             "label": rng.integers(0, 10, n).astype(np.int32)}
        if case == "accum":
            b = {k: v.reshape((2, 16) + v.shape[1:]) for k, v in b.items()}
        steps.append(b)
    if case == "window":
        return [{k: np.stack([b[k] for b in steps[:2]]) for k in steps[0]},
                steps[2]]
    return steps


def _gpt_calls(seed=2):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, GPT_CFG["vocab_size"],
                                       (GPT_BATCH, GPT_SEQ)).astype(np.int32)}
            for _ in range(CALLS)]


def _setup(model, calls, kw):
    """(loss, optimizer, build arguments) of either package, and the
    per-step sample batch."""
    K = kw.get("steps_per_call", 1)
    sample = calls[0] if K == 1 else {k: v[0] for k, v in calls[0].items()}
    return K, sample


def _port_chain(model, tree, calls, kw):
    """One port process, no mesh, the calls chained: losses and host
    states (index 0 the initial state). These states are where every
    side starts each call."""
    loss, opt, merge, clip = dp_check.cpu_train_setup(model)
    K, sample = _setup(model, calls, kw)
    build = dict(merge_stats=merge, grad_clip=clip,
                 accum_steps=kw.get("accum_steps", 1))
    step, state = build_train_step(
        loss, opt, bridge.params_from_numpy(tree, device="cpu"),
        bridge.params_from_numpy(sample, device="cpu"), steps_per_call=K,
        **build)
    fns = [step] * len(calls)
    if K > 1:
        single, _ = build_train_step(
            loss, opt, state["params"],
            bridge.params_from_numpy(sample, device="cpu"),
            init_state=False, **build)
        fns = [step] + [single] * (len(calls) - 1)
    states, losses = [bridge.params_to_numpy(state)], []
    for fn, b in zip(fns, calls):
        state, m = fn(state, bridge.params_from_numpy(b, device="cpu"))
        losses.append(m["loss"].numpy())
        states.append(bridge.params_to_numpy(state))
    return losses, states


def _jax_run(model, tree, calls, starts, kw):
    """JAX on a dp=2 mesh, call i started from ``starts[i]``: losses and
    host states after each call."""
    mesh = jmesh.make_mesh({"dp": 2}, jax.devices()[:2])
    K, sample = _setup(model, calls, kw)
    if model == "resnet":
        loss = lambda p, b: jres.loss_fn(p, b, dtype=jnp.float32)  # noqa
        opt = jopt.sgd(0.01, momentum=0.9, weight_decay=1e-4)
        build = dict(merge_stats=jres.merge_stats)
    else:
        loss = lambda p, b: jgpt.loss_fn(p, b, dtype=jnp.float32)  # noqa
        opt = jopt.adamw(jopt.cosine_schedule(3e-4, 3, 1), weight_decay=0.1)
        build = dict(grad_clip=1.0)
    build.update(mesh=mesh, cache=False,
                 accum_steps=kw.get("accum_steps", 1))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jsample = jax.tree_util.tree_map(jnp.asarray, sample)
    step, _ = jtrain.build_train_step(loss, opt, jtree, jsample,
                                      steps_per_call=K, **build)
    fns = [step] * len(calls)
    if K > 1:
        single, _ = jtrain.build_train_step(loss, opt, jtree, jsample,
                                            init_state=False, **build)
        fns = [step] + [single] * (len(calls) - 1)
    states, losses = [], []
    for fn, b, start in zip(fns, calls, starts):
        state, m = fn(jax.tree_util.tree_map(jnp.asarray, start),
                      jax.tree_util.tree_map(jnp.asarray, b))
        losses.append(np.asarray(m["loss"]))
        states.append(jax.tree_util.tree_map(np.array, state))
    return losses, states


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The calls' start states from one port process; then one two-worker
    world over every scenario, while JAX's dp=2 mesh runs the same calls
    from the same starts. Returns, by case, the starts and both
    references, and the output and checkpoint directories."""
    tmp = tmp_path_factory.mktemp("dp")
    out = str(tmp / "out")
    os.makedirs(out)
    gen = torch.Generator().manual_seed(0)
    trees = {"resnet": bridge.params_to_numpy(tres.init(gen, 18, 10)),
             "gpt": bridge.params_to_numpy(tgpt.init(gen, GPT_CFG))}
    for model, tree in trees.items():
        dp_check.save_tree(os.path.join(out, model + ".npz"), tree)
    cases = {name: ("resnet", _resnet_calls(name), kw)
             for name, kw in CASES.items()}
    cases["gpt"] = ("gpt", _gpt_calls(), {})
    ref, scenarios = {}, [{"kind": "bn", "name": "bn"}]
    for name, (model, calls, kw) in cases.items():
        losses, states = _port_chain(model, trees[model], calls, kw)
        ref[name] = {"starts": states[:-1], "port": (losses, states[1:])}
        files = {"batches": [], "starts": []}
        for i, (b, st) in enumerate(zip(calls, states)):
            for key, tree in (("batches", b), ("starts", st)):
                path = os.path.join(out, "%s.%s%d.npz" % (name, key, i))
                dp_check.save_tree(path, tree)
                files[key].append(path)
        scenarios.append(dict(kind="train", name=name, model=model,
                              tree=os.path.join(out, model + ".npz"),
                              **files, **kw))
    plain = next(sc for sc in scenarios if sc["name"] == "plain")
    scenarios.append(dict(plain, name="host_local", host_local=True))
    for name, fault in FAULT_CASES.items():
        scenarios.append(dict(plain, name=name, fault=fault))
    scenarios.append({"kind": "drain", "name": "drain",
                      "ckpt_dir": str(tmp / "ckpt"), "drain_rank": 1,
                      "drain_at": 3, "total_steps": 6})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        workers = pool.submit(
            dp_check.launch_workers, {"out": out, "scenarios": scenarios},
            world=2, backend="gloo", timeout=300,
            env={"OMP_NUM_THREADS": "2"})
        for name, (model, calls, kw) in cases.items():
            ref[name]["jax"] = _jax_run(model, trees[model], calls,
                                        ref[name]["starts"], kw)
        workers.result()
    return {"ref": ref, "out": out, "ckpt": str(tmp / "ckpt")}


def _got(world, name):
    return [_load(os.path.join(world["out"], "%s.rank%d.npz" % (name, r)))
            for r in (0, 1)]


@functools.lru_cache(maxsize=None)
def _load(path):
    return dp_check.load_tree(path)


def _state_close(got, want, tol=TOL):
    """Every leaf within ``tol`` of max(1, its largest magnitude)."""
    g, w = bridge.flatten(got), bridge.flatten(want)
    assert list(g) == list(w)
    for k in w:
        err = np.max(np.abs(np.asarray(w[k], np.float64) - g[k]))
        assert err <= tol * max(1.0, np.max(np.abs(w[k]))), (k, err)


def _gradient_borne(state, start):
    """The leaves of a ResNet state after a call that carry the gradient:
    each parameter's update (BatchNorm's running stats excluded) and the
    momentum, flat."""
    after, before = bridge.flatten(state), bridge.flatten(start)
    return np.concatenate([
        (after[k] - (before[k] if k.startswith("params/") else 0.0)).ravel()
        for k in after if k.startswith(("params/", "opt/momentum/"))
        and not k.endswith(("/mean", "/var"))])


def _resnet_close(got, want, start):
    """One call's ResNet state against the reference's: BatchNorm's
    running stats (a function of the forward) within rtol/atol TOL; the
    step count equal; the gradient-borne leaves within GRAD_RTOL of their
    norm."""
    g, w = bridge.flatten(got), bridge.flatten(want)
    assert list(g) == list(w) and g["opt/step"] == w["opt/step"]
    for k in w:
        if k.endswith(("/mean", "/var")):
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
    a, b = _gradient_borne(got, start), _gradient_borne(want, start)
    rel = np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel <= GRAD_RTOL, rel


def _matches(world, name, case=None, against="jax"):
    """Both ranks against a reference run of ``case`` (default ``name``),
    JAX's dp=2 run or one port process, call by call: losses within
    rtol/atol TOL, the state as :func:`_resnet_close`, and the two
    replicas bit for bit."""
    ref = world["ref"][case or name]
    want_losses, want_states = ref[against]
    r0, r1 = _got(world, name)
    for got in (r0, r1):
        for want_l, got_l in zip(want_losses, got["losses"]):
            np.testing.assert_allclose(got_l, want_l, rtol=TOL, atol=TOL)
        for start, want, state in zip(ref["starts"], want_states,
                                      got["states"]):
            _resnet_close(state, want, start)
    for a, b in zip(r0["states"], r1["states"]):
        fa, fb = bridge.flatten(a), bridge.flatten(b)
        for k in fa:
            assert np.array_equal(fa[k], fb[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_dp_train_step_matches_jax_mesh(world, case):
    _matches(world, case)
    stats = _got(world, case)[0]["states"][-1]["params"]["stem"]["bn"]
    assert np.abs(stats["mean"]).sum() > 0       # merge_stats ran


def test_dp_matches_one_port_process(world):
    """The two-worker run against the port in one process (no mesh),
    each call from the same start."""
    _matches(world, "plain", against="port")


def test_host_local_batches_equal_global(world):
    for a, b in zip(_got(world, "plain"), _got(world, "host_local")):
        fa, fb = bridge.flatten(a), bridge.flatten(b)
        assert list(fa) == list(fb)
        for k in fa:
            assert np.array_equal(fa[k], fb[k]), k


@pytest.mark.parametrize("name", list(FAULT_CASES))
def test_planted_faults_are_rejected(world, name):
    with pytest.raises(AssertionError):
        _matches(world, name, case="plain")


def test_sync_batchnorm_matches_one_process(world):
    full = dp_check.bn_grads(dp_check.bn_case())
    local = dp_check.bn_grads({k: process_shard(v, 0, 2) if k in ("x", "cot")
                               else v for k, v in dp_check.bn_case().items()})
    r0, r1 = _got(world, "bn")
    for k in ("y", "dx"):
        got = np.concatenate([r0[k], r1[k]])
        np.testing.assert_allclose(got, full[k], rtol=1e-5, atol=1e-5)
    for k in ("dscale", "dbias"):
        np.testing.assert_allclose(r0[k] + r1[k], full[k], rtol=1e-5,
                                   atol=1e-5)
    for k in ("mean", "var"):
        assert np.array_equal(r0[k], r1[k])
        np.testing.assert_allclose(r0[k], full[k], rtol=1e-5, atol=1e-5)
    # a local BatchNorm is plainly another function on this batch
    assert np.max(np.abs(local["y"] - full["y"][:4])) > 1e-2


def test_gpt_dp_matches_jax_mesh(world):
    want_losses, want_states = world["ref"]["gpt"]["jax"]
    for got in _got(world, "gpt"):
        for want_l, got_l in zip(want_losses, got["losses"]):
            assert abs(float(got_l) - float(want_l)) <= 1e-5 * abs(
                float(want_l))
        for want, state in zip(want_states, got["states"]):
            _state_close(state, want)


def test_one_rank_drain_stops_both_ranks(world):
    r0, r1 = _got(world, "drain")
    for r in (r0, r1):
        assert bool(r["drained"]) and int(r["drain_step"]) == 3
        assert int(r["steps"]) == 3
        assert [dict((k, int(v)) for k, v in m.items())
                for m in r["mesh_history"]] == [{"dp": 2}]
        assert [int(s) for s in r["resume_steps"]] == [3]
        assert int(r["resumed_steps"]) == 5
    assert float(r0["resumed_loss"]) == float(r1["resumed_loss"])
    assert tckpt.all_steps(world["ckpt"])[0] == 3
    manifest = json.load(open(os.path.join(
        world["ckpt"], "step_%012d" % 3, "manifest.json")))
    assert manifest["format"] == "sharded"
    # both packages read the step the two workers wrote
    want = bridge.flatten(r0["state"])
    port, _ = tckpt.restore_checkpoint(world["ckpt"], step=3)
    ref, _ = jckpt.restore_checkpoint(world["ckpt"], step=3)
    for tree in (port, ref):
        got = bridge.flatten(jax.tree_util.tree_map(np.asarray, tree))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(got[k], v), k


def test_jax_sharded_step_restores_in_port(world, tmp_path):
    """A step the JAX package writes sharded (the dp=2 state of the plain
    case, and a leaf split over 4 devices) reads back in the port."""
    mesh = jmesh.make_mesh({"dp": 4}, jax.devices()[:4])
    from jax.sharding import NamedSharding, PartitionSpec as P

    params = world["ref"]["plain"]["jax"][1][-1]["params"]
    split = jax.device_put(jnp.arange(32.0).reshape(8, 4),
                           NamedSharding(mesh, P("dp", None)))
    state = {"params": jax.device_put(params, NamedSharding(mesh, P())),
             "split": split}
    jckpt.save_checkpoint_sharded(str(tmp_path), 7, state)
    got, manifest = tckpt.restore_latest(str(tmp_path))
    assert manifest["format"] == "sharded" and manifest["step"] == 7
    np.testing.assert_array_equal(got["split"], np.arange(32.0).reshape(8, 4))
    live = bridge.params_from_numpy({"params": params}, device="cpu")
    tckpt.load_into(live, {"params": got["params"]})
    for k, v in bridge.flatten(params).items():
        assert np.array_equal(bridge.flatten(got["params"])[k], v), k


# ---------------------------------------------------------------------------
# pieces against the reference, in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count", [1, 2, 4])
def test_process_shard_matches_reference(count):
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((8, 3)), "y": np.arange(8)}
    for i in range(count):
        want = jdata.process_shard(batch, i, count)
        got = process_shard(batch, i, count)
        for k in batch:
            assert np.array_equal(got[k], want[k])
        t = process_shard(bridge.params_from_numpy(batch, device="cpu"), i,
                          count)
        assert np.array_equal(t["x"].numpy(), want["x"])
    with pytest.raises(ValueError) as want_e:
        jdata.process_shard({"x": np.zeros((6, 2))}, 0, 4)
    with pytest.raises(ValueError) as got_e:
        process_shard({"x": np.zeros((6, 2))}, 0, 4)
    assert str(got_e.value) == str(want_e.value)


def test_process_shard_takes_the_batch_axis():
    """Under a window or a microbatch stack the block is cut on axis 1
    (2 under both); scalars stay whole."""
    x = np.arange(2 * 3 * 4).reshape(2, 3, 4)
    got = process_shard({"x": x, "s": np.float32(1)}, 1, 2, axis=2)
    assert np.array_equal(got["x"], x[:, :, 2:]) and got["s"] == 1


@pytest.mark.parametrize("axes,world", [
    (None, 1), (None, 4), ({"dp": -1}, 4), ({"dp": 2, "fsdp": 1}, 2),
    ({"dp": 3}, 4), ({"dp": -1, "fsdp": -1}, 4), ({"dp": -1, "tp": 3}, 4),
])
def test_make_mesh_matches_reference(axes, world):
    devices = jax.devices()[:world]
    try:
        want = dict(jmesh.make_mesh(axes, devices).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make_mesh(axes, world=world)
        assert str(got.value) == str(e)
        return
    got = make_mesh(axes, world=world)
    assert got.shape == want and got.size == world and got.group is None


def test_make_mesh_refuses_other_axes(monkeypatch):
    with pytest.raises(NotImplementedError, match="A9"):
        make_mesh({"dp": 2, "tp": 2}, world=4)
    monkeypatch.setenv("TPUJOB_MESH", "dp=2")
    assert mesh_from_env(world=2).shape == {"dp": 2}
    monkeypatch.setenv("TPUJOB_DCN_MESH", "dp=2")
    with pytest.raises(NotImplementedError):
        mesh_from_env(world=4)


@pytest.mark.parametrize("k", [1, 3])
def test_window_source_matches_reference(k):
    """``force_host_windows``: windows of K steps stacked on the host,
    singles for the tail, as the reference's source yields them."""
    def make(gen, step):
        return {"x": torch.full((2,), float(step))}

    got = list(job_window_source(make, 0, 0, 4, steps_per_call=k,
                                 device="cpu", force_host_windows=True))
    want = list(jdata.job_window_source(
        lambda rng, step: {"x": np.full((2,), float(step), np.float32)},
        jax.random.PRNGKey(0), 0, 4, steps_per_call=k,
        force_host_windows=True))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g["x"]), np.asarray(w["x"]))
        assert isinstance(g["x"], np.ndarray) == (np.ndim(w["x"]) == 2)
    window = stack_window([make(None, 0), make(None, 1)])
    assert isinstance(window["x"], torch.Tensor)


def test_bucket_plan_and_identity_without_a_group():
    """Buckets are runs of one dtype up to the cap (a larger tensor alone);
    without a group (one process) every collective is the identity."""
    ts = [torch.zeros(4), torch.zeros(4), torch.zeros(2, dtype=torch.float64),
          torch.zeros(100), torch.zeros(1)]
    assert collectives.bucket_plan(ts, cap=40) == [[0, 1], [2], [3], [4]]
    grads = {"a": torch.ones(3), "stat": None}
    assert collectives.mean_grads(grads, None) is grads
    metrics = {"loss": torch.tensor(2.0), "n": 3}
    assert collectives.mean_metrics(metrics, None) is metrics
    x = torch.ones(2, requires_grad=True)
    assert collectives.mean_with_grad(x, None) is x
    assert collectives.max_int(3, None) == 3 == collectives.min_int(3, None)
    collectives.barrier(None)
    with collectives.sync_batch("g"):
        assert collectives.batch_group() == "g"
    assert collectives.batch_group() is None


def test_launch_main_needs_a_script(capsys):
    from paddle_operator_tpu_torch import launch

    assert launch.main([]) == 2
    assert "usage" in capsys.readouterr().err
