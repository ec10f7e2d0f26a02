"""The torch port's train step against the JAX package's
``build_train_step``, on a JAX-initialised ResNet-18 (10 classes, 32x32
images, batch 8) with plain SGD at lr 0.01, momentum, weight decay and
``merge_stats``.

Each case runs three optimizer steps on both sides from the same tree and
the same numpy batches, in fp32: plain steps, ``grad_clip``,
``accum_steps=2``, and ``steps_per_call=2`` (one fused call of a ``[2,
...]`` window, then a single tail step). Each ``step_fn`` call of the
port starts from the JAX state before that call, and its losses and its
whole state after the call (params with BN running stats, momentum,
step) are held against JAX's: losses within 1e-4 (relative), every
other leaf within 1e-4 of its largest magnitude (or of 1, if larger).

Why each call restarts from JAX's state: sums run in another order on
each side, and chained steps amplify the grads' differences (see
``tests/test_torch_resnet.py``) until a ReLU input near zero falls on
the other side; three chained steps then part by 1e-3 for no fault of
either. The sizes keep every BatchNorm over at least 32 values per
channel for the same reason.
"""

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge
from paddle_operator_tpu_torch.models import resnet as tres
from paddle_operator_tpu_torch.ops import optim as topt
from paddle_operator_tpu_torch.parallel import build_train_step
from paddle_operator_tpu_torch.parallel import sharding as tsharding
from paddle_operator_tpu_torch.parallel.mesh import make_mesh
from paddle_operator_tpu_torch.utils.checkpoint import load_into

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from paddle_operator_tpu.models import resnet as jres  # noqa: E402
from paddle_operator_tpu.ops import optim as jopt  # noqa: E402
from paddle_operator_tpu.parallel import train as jtrain  # noqa: E402

STEPS = 3
CASES = {
    "plain": {},
    "grad_clip": {"grad_clip": 0.5},
    "accum": {"accum_steps": 2},
    "window": {"steps_per_call": 2},
}


@pytest.fixture(scope="module")
def tree():
    return jax.tree_util.tree_map(
        np.asarray, jres.init(jax.random.PRNGKey(0), depth=18,
                              num_classes=10))


def _batches(case, seed=1):
    """Per-step numpy batches of 8; for accum, two microbatches of 8."""
    rng = np.random.default_rng(seed)
    n = 16 if case == "accum" else 8
    out = []
    for _ in range(STEPS):
        b = {"image": rng.standard_normal((n, 32, 32, 3), dtype=np.float32),
             "label": rng.integers(0, 10, n).astype(np.int32)}
        if case == "accum":
            b = {k: v.reshape((2, 8) + v.shape[1:]) for k, v in b.items()}
        out.append(b)
    return out


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _calls(case):
    """The batches of each step_fn call: a [2, ...] window then a single
    tail batch for "window", one batch per call otherwise."""
    batches = _batches(case)
    if case == "window":
        return [_stack(batches[:2]), batches[2]]
    return batches


def _jax_run(tree, case):
    """JAX losses per call and the host state after each call (index 0:
    the initial state)."""
    kw = CASES[case]
    opt = jopt.sgd(0.01, momentum=0.9, weight_decay=1e-4)
    loss = lambda p, b: jres.loss_fn(p, b, dtype=jnp.float32)  # noqa: E731
    sample = jax.tree_util.tree_map(jnp.asarray, _batches(case)[0])
    build = dict(merge_stats=jres.merge_stats, cache=False,
                 grad_clip=kw.get("grad_clip"),
                 accum_steps=kw.get("accum_steps", 1))
    step, state = jtrain.build_train_step(
        loss, opt, jax.tree_util.tree_map(jnp.asarray, tree), sample,
        steps_per_call=kw.get("steps_per_call", 1), **build)
    fns = [step] * STEPS
    if case == "window":
        single, _ = jtrain.build_train_step(loss, opt, state["params"],
                                            sample, init_state=False, **build)
        fns = [step, single]
    host = lambda s: jax.tree_util.tree_map(np.array, s)  # noqa: E731
    states, losses = [host(state)], []
    for fn, b in zip(fns, _calls(case)):
        state, m = fn(state, jax.tree_util.tree_map(jnp.asarray, b))
        losses.append(np.asarray(m["loss"]))
        states.append(host(state))
    return losses, states


def _port_run(tree, case, jax_states):
    """The port's call i starts from JAX's state before call i; returns
    the port's losses and host state after each call."""
    kw = CASES[case]
    opt = topt.sgd(0.01, momentum=0.9, weight_decay=1e-4)
    loss = lambda p, b: tres.loss_fn(p, b, dtype=torch.float32)  # noqa: E731
    sample = bridge.params_from_numpy(_batches(case)[0], device="cpu")
    build = dict(merge_stats=tres.merge_stats,
                 grad_clip=kw.get("grad_clip"),
                 accum_steps=kw.get("accum_steps", 1))
    step, state = build_train_step(
        loss, opt, bridge.params_from_numpy(tree, device="cpu"), sample,
        steps_per_call=kw.get("steps_per_call", 1), **build)
    fns = [step] * STEPS
    if case == "window":
        single, none = build_train_step(loss, opt, state["params"], sample,
                                        init_state=False, **build)
        assert none is None
        fns = [step, single]
    losses, states = [], []
    for fn, b, start in zip(fns, _calls(case), jax_states):
        load_into(state, start)
        state, m = fn(state, bridge.params_from_numpy(b, device="cpu"))
        losses.append(m["loss"].numpy())
        if case == "grad_clip":
            assert float(m["grad_norm"]) > 0.5   # the clip is active
        if fn is step and case == "window":
            assert tuple(m["loss"].shape) == (2,) and "accuracy" in m
        states.append(bridge.params_to_numpy(state))
    assert int(state["opt"]["step"]) == STEPS
    return losses, states


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(tree, case):
    want_losses, want_states = _jax_run(tree, case)
    got_losses, got_states = _port_run(tree, case, want_states)
    for want_l, got_l in zip(want_losses, got_losses):
        np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=1e-4)
    for want, got in zip(want_states[1:], got_states):
        w, g = bridge.flatten(want), bridge.flatten(got)
        assert list(w) == list(g)
        assert w["opt/step"] == g["opt/step"]
        for k in w:
            err = np.max(np.abs(w[k] - g[k]))
            assert err <= 1e-4 * max(1.0, np.max(np.abs(w[k]))), (k, err)
    # merge_stats ran after the update: running means moved off zero
    assert np.abs(got_states[-1]["params"]["stem"]["bn"]["mean"]).sum() > 0


def test_state_is_a_copy_and_updates_in_place(tree):
    params = bridge.params_from_numpy(tree, device="cpu")
    batch = bridge.params_from_numpy(_batches("plain")[0], device="cpu")
    step, state = build_train_step(
        lambda p, b: tres.loss_fn(p, b, dtype=torch.float32),
        topt.fused_sgd(0.01), params, batch, merge_stats=tres.merge_stats)
    kernel = state["params"]["stem"]["conv"]["kernel"]
    assert kernel is not params["stem"]["conv"]["kernel"]
    out, metrics = step(state, batch)
    assert out is state and out["params"]["stem"]["conv"]["kernel"] is kernel
    assert np.array_equal(params["stem"]["conv"]["kernel"].numpy(),
                          tree["stem"]["conv"]["kernel"])
    assert not metrics["loss"].requires_grad


def test_mesh_is_refused(tree):
    """What the port cannot shard still raises: a pp axis in the train
    step (it names ``pipeline_apply``), a sequence axis the mesh lacks,
    rules over an axis no tile code reads (dp) or that no layer computes
    on (the CTR tables over tp, ROADMAP A5). Rules over axes the mesh
    lacks mean "replicated", as in the reference
    (``tests/test_parallel.py::test_rules_survive_missing_axis``); tp and
    fsdp meshes build, and so do tp beside sp and fsdp beside ep."""
    assert make_mesh({"dp": 1, "pp": 2}, world=2).shape == {"dp": 1,
                                                            "pp": 2}
    assert make_mesh({"dp": 1, "tp": 2}, world=2).shape == {"dp": 1,
                                                            "tp": 2}
    assert make_mesh({"dp": 1, "fsdp": 2}, world=2).shape == {"dp": 1,
                                                              "fsdp": 2}
    mesh = make_mesh({"dp": 1})
    params = bridge.params_from_numpy(tree, device="cpu")
    batch = bridge.params_from_numpy(_batches("plain")[0], device="cpu")
    args = (tres.loss_fn, topt.sgd(0.1), params, batch)
    with pytest.raises(NotImplementedError):
        build_train_step(*args, mesh=mesh, seq_axis="sp")
    with pytest.raises(NotImplementedError, match="A5"):
        build_train_step(*args, mesh=make_mesh({"dp": 2}, world=2),
                         rules=[(r"head/fc/kernel", (None, "dp"))])
    with pytest.raises(NotImplementedError, match="pipeline_apply"):
        build_train_step(*args, mesh=make_mesh({"dp": 1, "pp": 2},
                                               world=2))
    for axes in ({"tp": 2, "sp": 2}, {"fsdp": 2, "ep": 2}):
        _, built = build_train_step(*args, mesh=make_mesh(axes, world=4),
                                    seq_axis="sp" if "sp" in axes
                                    else None)
        assert built["params"]["head"]["fc"]["kernel"].shape == \
            params["head"]["fc"]["kernel"].shape
    with pytest.raises(NotImplementedError, match="A5"):
        build_train_step(*args, mesh=make_mesh({"tp": 2}, world=2),
                         rules=tsharding.ctr_rules())
    with pytest.raises(ValueError):
        build_train_step(*args, mesh=mesh, batch_axis="data")
    step, state = build_train_step(
        *args, mesh=mesh, rules=[(r"head/fc/kernel", (None, "fsdp"))])
    assert mesh.group is None and state["params"]["head"]["fc"][
        "kernel"].shape == params["head"]["fc"]["kernel"].shape
