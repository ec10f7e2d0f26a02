"""The CTR models of the torch port (``models/wide_deep.py``,
``models/deepfm.py``, ``ops/nn.sigmoid_binary_cross_entropy``,
``examples/train_wide_deep.py``, ``examples/train_deepfm.py``) against
the JAX package's, on the CPU.

Trees are JAX-initialised at a small configuration (``TINY``: 8 slots x
100 ids, embed 8, hidden 32-32, as ``tests/test_ps_mode.py``) and carried
across by the bridge; batches are numpy from a seed.

* fp32: ``loss_fn``'s loss within 1e-6, its accuracy equal, and every
  gradient leaf within 1e-5 of the leaf's largest magnitude;
  ``sparse_loss_fn`` likewise, with the gradient of the pulled ``rows``.
* bf16 (the compute type of the examples): the class of
  :func:`_bf16_class`, derived in its docstring.
* DeepFM's FM second-order term is computed in bf16 as the reference
  computes it: the port's term is within one bf16 ulp of JAX's, and the
  term planted in fp32 (the "improvement" the port must not make) parts
  from it by many ulps.
* ``sigmoid_binary_cross_entropy`` at logits of -100, 0 and 100, value
  and gradient within 1e-6.
* ``make_job`` of both examples: three train steps against JAX's
  ``build_train_step`` with ``adamw(1e-3)``, in fp32, each started from
  JAX's state (as ``tests/test_torch_train.py`` does): the moments at
  the optimizer's class (rtol 5e-6, atol 1e-6; ``tests/test_fused_ops.py``),
  the parameters at it plus what the two sides' moments imply
  (:func:`_hold_adamw_state`); two steps of ``run_training`` on the
  CPU at the examples' widths; and the wide&deep example under
  ``launch`` with two gloo workers against one process.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge
from paddle_operator_tpu_torch.dp_check import free_port
from paddle_operator_tpu_torch.examples import train_deepfm, train_wide_deep
from paddle_operator_tpu_torch.models import deepfm as tfm
from paddle_operator_tpu_torch.models import wide_deep as twd
from paddle_operator_tpu_torch.ops import nn as tnn
from paddle_operator_tpu_torch.parallel import build_train_step
from paddle_operator_tpu_torch.runner import run_training
from paddle_operator_tpu_torch.utils.checkpoint import load_into

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from paddle_operator_tpu.models import deepfm as jfm  # noqa: E402
from paddle_operator_tpu.models import wide_deep as jwd  # noqa: E402
from paddle_operator_tpu.ops import nn as jnn  # noqa: E402
from paddle_operator_tpu.ops import optim as jopt  # noqa: E402
from paddle_operator_tpu.parallel import train as jtrain  # noqa: E402

TINY = dict(num_slots=8, vocab_per_slot=100, embed_dim=8, dense_dim=13,
            hidden=[32, 32])
MODELS = {"wide_deep": (jwd, twd), "deepfm": (jfm, tfm)}
BATCH = 64
F32, BF16 = torch.float32, torch.bfloat16
U = 2.0 ** -8      # one bf16 rounding, relative


@functools.lru_cache(maxsize=None)
def _tree(name, dense_only=False, seed=0):
    jm = MODELS[name][0]
    init = jm.init_dense if dense_only else jm.init
    return jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(seed), TINY))


def _batch(seed=0, batch=BATCH, cfg=TINY):
    rng = np.random.default_rng(seed)
    return {"sparse": rng.integers(0, cfg["vocab_per_slot"],
                                   (batch, cfg["num_slots"])).astype(np.int64),
            "dense": rng.standard_normal(
                (batch, cfg["dense_dim"])).astype(np.float32),
            "label": rng.integers(0, 2, (batch,)).astype(np.int32)}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port(tree):
    return bridge.params_from_numpy(tree, device="cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_loss(name, dtype, seed=0):
    jm = MODELS[name][0]
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, dtype=dtype), has_aux=True))(
            _jnp(_tree(name)), _jnp(_batch(seed)))
    logits = jax.jit(lambda p, b: jm.apply(p, b, dtype))(
        _jnp(_tree(name)), _jnp(_batch(seed)))
    return (float(loss), float(aux["accuracy"]), np.asarray(logits),
            bridge.flatten(jax.tree_util.tree_map(np.asarray, grads)))


def _port_loss(name, dtype, seed=0, tree=None):
    tm = MODELS[name][1]
    params = _port(_tree(name) if tree is None else tree)
    leaves = bridge.flatten(params)
    for t in leaves.values():
        t.requires_grad_()
    loss, aux = tm.loss_fn(params, _torch_batch(_batch(seed)), dtype=dtype)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        logits = tm.apply(params, _torch_batch(_batch(seed)), dtype)
    return (float(loss.detach()), float(aux["accuracy"]),
            logits.float().numpy(),
            {k: g.numpy() for k, g in zip(leaves, grads)})


def _leaf_errors(got, want):
    """Each leaf's largest |got - want| over its largest |want|."""
    assert sorted(got) == sorted(want)
    return {k: float(np.max(np.abs(got[k] - want[k]))
                     / max(float(np.max(np.abs(want[k]))), 1e-30))
            for k in want}


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def test_sigmoid_bce_matches_jax_at_extremes():
    logits = np.array([-100.0, -100.0, 0.0, 0.0, 100.0, 100.0, 3.5, -2.25],
                      np.float32)
    labels = np.array([0, 1, 0, 1, 0, 1, 1, 0], np.int32)
    want, want_g = jax.value_and_grad(jnn.sigmoid_binary_cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels))
    x = torch.from_numpy(logits).requires_grad_()
    got = tnn.sigmoid_binary_cross_entropy(x, torch.from_numpy(labels))
    (got_g,) = torch.autograd.grad(got, [x])
    got = float(got.detach())
    assert np.isfinite(got)
    assert abs(got - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-6)
    # at a logit of 0 the slope is JAX's: -y / n
    assert float(got_g[2]) == 0.0 and float(got_g[3]) == -1.0 / 8


# ---------------------------------------------------------------------------
# the models in fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_fn_and_grads_match_jax_fp32(name):
    want_l, want_acc, want_logits, want_g = _jax_loss(name, jnp.float32)
    got_l, got_acc, got_logits, got_g = _port_loss(name, F32)
    assert abs(got_l - want_l) <= 1e-6
    assert got_acc == want_acc
    np.testing.assert_allclose(got_logits, want_logits, rtol=0, atol=1e-5)
    errs = _leaf_errors(got_g, want_g)
    assert max(errs.values()) <= 1e-5, errs


def _sparse_case(name, seed=3):
    """A dense-only tree, the rows a batch touches (the fused table
    ``[embed | first-or-wide]`` of width embed_dim + 1) and its ids."""
    tree = _tree(name, dense_only=True)
    batch = _batch(seed)
    raw = np.asarray(twd.sparse_ids(_torch_batch(batch),
                                    TINY["vocab_per_slot"]))
    uids, inv = np.unique(raw, return_inverse=True)
    rng = np.random.default_rng(seed)
    rows = (rng.standard_normal((len(uids), TINY["embed_dim"] + 1))
            * 0.05).astype(np.float32)
    return tree, batch, rows, inv.ravel()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_sparse_loss_fn_and_row_grads_match_jax(name):
    jm, tm = MODELS[name]
    tree, batch, rows, inv = _sparse_case(name)
    (want_l, _), (want_g, want_rows) = jax.value_and_grad(
        lambda p, r: jm.sparse_loss_fn(p, r, jnp.asarray(inv), _jnp(batch),
                                       dtype=jnp.float32),
        argnums=(0, 1), has_aux=True)(_jnp(tree), jnp.asarray(rows))
    params = _port(tree)
    leaves = bridge.flatten(params)
    for t in leaves.values():
        t.requires_grad_()
    trows = torch.from_numpy(rows).requires_grad_()
    loss, _ = tm.sparse_loss_fn(params, trows, torch.from_numpy(inv),
                                _torch_batch(batch), dtype=F32)
    *grads, grows = torch.autograd.grad(loss, list(leaves.values()) + [trows])
    assert abs(float(loss.detach()) - float(want_l)) <= 1e-6
    errs = _leaf_errors(
        {**{k: g.numpy() for k, g in zip(leaves, grads)},
         "rows": grows.numpy()},
        {**bridge.flatten(jax.tree_util.tree_map(np.asarray, want_g)),
         "rows": np.asarray(want_rows)})
    assert max(errs.values()) <= 1e-5, errs


def test_sparse_ids_fold_slots_slot_major():
    batch = _torch_batch(_batch(1, batch=4))
    got = twd.sparse_ids(batch, TINY["vocab_per_slot"])
    want = np.asarray(jwd.sparse_ids(_jnp(_batch(1, batch=4)),
                                      TINY["vocab_per_slot"]))
    assert got.dtype == np.int64 and got.shape == (4 * TINY["num_slots"],)
    np.testing.assert_array_equal(got, want)
    assert tfm.sparse_ids is twd.sparse_ids
    assert twd.sparse_row_dim(TINY) == tfm.sparse_row_dim(TINY) == 9


@pytest.mark.parametrize("name", sorted(MODELS))
def test_init_matches_the_jax_tree_structure(name):
    jm, tm = MODELS[name]
    for dense_only in (False, True):
        init = tm.init_dense if dense_only else tm.init
        got = bridge.flatten(init(torch.Generator().manual_seed(0), TINY))
        want = bridge.flatten(_tree(name, dense_only))
        assert list(got) == list(want), name
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert got[k].dtype == F32, k
    # the default configuration's dense vector (the sparse-PS push)
    n = sum(t.numel() for t in bridge.leaves(
        twd.init_dense(torch.Generator().manual_seed(0))))
    assert n == 494_625


def test_synthetic_batch_layout():
    for tm in (twd, tfm):
        b = tm.synthetic_batch(torch.Generator().manual_seed(0), 16, TINY)
        assert b["sparse"].dtype == torch.int64
        assert tuple(b["sparse"].shape) == (16, TINY["num_slots"])
        assert int(b["sparse"].min()) >= 0
        assert int(b["sparse"].max()) < TINY["vocab_per_slot"]
        assert b["dense"].dtype == F32
        assert tuple(b["dense"].shape) == (16, TINY["dense_dim"])
        assert b["label"].dtype == torch.int32
        assert set(b["label"].tolist()) <= {0, 1}
    full = twd.synthetic_batch(torch.Generator().manual_seed(0), 2)
    assert tuple(full["sparse"].shape) == (2, 26)


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

def _bf16_class(name):
    """The bf16 class, per gradient leaf, relative to the leaf's largest
    fp32 magnitude: ``2 U L`` with ``U = 2^-8`` and ``L`` the number of
    bf16 layer outputs on the model's path.

    Derivation. In bf16 both packages run the same operations: each dense
    layer casts its operands to bf16, accumulates in fp32 and rounds its
    output to bf16 once, and autograd rounds each layer's cotangent to
    bf16 once on the way back. Where the two accumulate in another order,
    the fp32 sums differ in their last bits only, and a rounding can fall
    on the other side of a bf16 boundary: that output then differs by one
    bf16 ulp, at most ``2 U`` of its magnitude. A gradient leaf is a
    product and sum of such outputs, each entering once, so to first
    order it moves by at most ``2 U`` of its magnitude per rounding on
    its path. The deep tower of ``TINY`` has ``1 + len(hidden)`` bf16
    layers (the dense projection or the input cast, then each hidden
    layer), each rounded once forward and once backward: ``L = 2 (1 +
    len(hidden))`` = 6, a class of 0.047. The loss sees the forward
    roundings only, through an fp32 output layer and the BCE, whose
    slope is at most 1: ``|loss - loss_jax| <= 2 U (1 + len(hidden))``
    times the largest logit."""
    return 2 * U * 2 * (1 + len(TINY["hidden"]))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_fn_bf16_within_the_rounding_class(name):
    want_l, _, want_logits, want_g = _jax_loss(name, jnp.bfloat16)
    got_l, _, got_logits, got_g = _port_loss(name, BF16)
    _, _, _, f32_g = _jax_loss(name, jnp.float32)
    cls = _bf16_class(name)
    logit_scale = float(np.max(np.abs(want_logits)))
    assert abs(got_l - want_l) <= cls / 2 * logit_scale
    for k, g in got_g.items():
        scale = float(np.max(np.abs(f32_g[k])))
        err = float(np.max(np.abs(g.astype(np.float32) - want_g[k])))
        assert err <= cls * scale, (k, err / scale, cls)


def _fm_logits_only(tree):
    """The DeepFM tree with the deep tower's output layer, the dense
    first-order weight and the first-order table zeroed: its logit is the
    FM second-order term alone."""
    tree = jax.tree_util.tree_map(np.array, tree)
    for key in ("out", "dense_w"):
        tree[key] = {k: np.zeros_like(v) for k, v in tree[key].items()}
    tree["fm_first"]["table"][:] = 0
    tree["fm_embed"]["table"] *= 10.0   # a trained table's scale
    return tree


def _bf16_ulp(x):
    """One bf16 ulp of |x| (2^(e - 7) for |x| in [2^e, 2^(e+1)))."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


def _second_order_fp32(params, emb, first_order, batch, dtype):
    """The planted fault: DeepFM's ``_logits`` with the FM second-order
    term computed in fp32 instead of the compute type."""
    first = first_order + tnn.dense(params["dense_w"], batch["dense"],
                                    F32)[:, 0]
    e = emb.float()
    second = 0.5 * (torch.square(e.sum(dim=1))
                    - torch.square(e).sum(dim=1)).sum(dim=-1)
    b = emb.shape[0]
    deep = torch.cat([emb.reshape(b, -1), batch["dense"].to(dtype)], dim=-1)
    for layer in params["mlp"]:
        deep = torch.relu(tnn.dense(layer, deep, dtype))
    return first + second + tnn.dense(params["out"], deep, F32)[:, 0]


def test_deepfm_second_order_in_bf16_as_the_reference(monkeypatch):
    """Class: the term is one bf16 layer output (computed in bf16, cast
    to fp32 after), so the port is held to one bf16 ulp of JAX's term,
    row by row. The planted fp32 term must fail that class: the bf16
    difference of squares cancels, so the two types part by many ulps."""
    tree = _fm_logits_only(_tree("deepfm"))
    want = np.asarray(jfm.apply(_jnp(tree), _jnp(_batch(4)), jnp.bfloat16))
    got = tfm.apply(_port(tree), _torch_batch(_batch(4)), BF16).numpy()
    assert np.all(np.abs(got - want) <= _bf16_ulp(want))
    monkeypatch.setattr(tfm, "_logits", _second_order_fp32)
    planted = tfm.apply(_port(tree), _torch_batch(_batch(4)), BF16).numpy()
    assert np.max(np.abs(planted - want) / _bf16_ulp(want)) > 4.0


# ---------------------------------------------------------------------------
# the examples' jobs
# ---------------------------------------------------------------------------

EXAMPLES = {"wide_deep": train_wide_deep, "deepfm": train_deepfm}


def _tiny_job(name, env=None):
    """The example's job with the model at TINY (only the widths change:
    the optimizer, loss and batch schema are the example's)."""
    tm = MODELS[name][1]
    job = EXAMPLES[name].make_job(env or {})
    return dataclasses.replace(
        job, init_params=lambda gen: tm.init(gen, TINY),
        make_batch=lambda gen, step: tm.synthetic_batch(gen, BATCH, TINY))


def _jax_steps(name, batches):
    jm = MODELS[name][0]
    step, state = jtrain.build_train_step(
        lambda p, b: jm.loss_fn(p, b, dtype=jnp.float32),
        jopt.adamw(1e-3), _jnp(_tree(name)), _jnp(batches[0]), cache=False)
    host = lambda s: jax.tree_util.tree_map(np.array, s)  # noqa: E731
    states, losses = [host(state)], []
    for b in batches:
        state, m = step(state, _jnp(b))
        losses.append(float(m["loss"]))
        states.append(host(state))
    return losses, states


@pytest.mark.parametrize("name", sorted(MODELS))
def test_make_job_steps_match_jax_adamw(name):
    job = _tiny_job(name)
    tm = MODELS[name][1]
    batches = [_batch(seed) for seed in (20, 21, 22)]
    want_losses, want_states = _jax_steps(name, batches)
    step, state = build_train_step(
        lambda p, b: tm.loss_fn(p, b, dtype=F32), job.optimizer,
        _port(_tree(name)), _torch_batch(batches[0]))
    for b, start, want_l, want in zip(batches, want_states, want_losses,
                                      want_states[1:]):
        load_into(state, start)
        state, m = step(state, _torch_batch(b))
        assert abs(float(m["loss"]) - want_l) <= 1e-6
        got = bridge.params_to_numpy(state)
        _hold_adamw_state(got, want, step=int(want["opt"]["step"]))
    assert int(state["opt"]["step"]) == 3


def _adam_direction(mu, nu, step, b1=0.9, b2=0.999, eps=1e-8):
    mu, nu = np.asarray(mu, np.float64), np.asarray(nu, np.float64)
    return (mu / (1 - b1 ** step)) / (np.sqrt(nu / (1 - b2 ** step)) + eps)


def _hold_adamw_state(got, want, step, lr=1e-3):
    """The moments at the optimizer's class; the parameters at it plus
    ``lr`` times the gap between the update directions ``m/(sqrt(v)+eps)``
    of the two sides' own moments. Where a gradient is near ``eps`` (an
    embedding row whose contributions cancel), the direction amplifies
    the gradients' last-bit differences by up to ``1/(4 eps |g|)``,
    which no relative class of the parameters can hold; the moments
    carry the gradients' agreement."""
    for part in ("mu", "nu"):
        g, w = bridge.flatten(got["opt"][part]), bridge.flatten(
            want["opt"][part])
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=5e-6, atol=1e-6,
                                       err_msg="%s/%s" % (part, k))
    gp, wp = bridge.flatten(got["params"]), bridge.flatten(want["params"])
    assert sorted(gp) == sorted(wp)
    for k in wp:
        gap = lr * np.abs(
            _adam_direction(bridge.flatten(got["opt"]["mu"])[k],
                            bridge.flatten(got["opt"]["nu"])[k], step)
            - _adam_direction(bridge.flatten(want["opt"]["mu"])[k],
                              bridge.flatten(want["opt"]["nu"])[k], step))
        bound = 1e-6 + 5e-6 * np.abs(wp[k]) + gap
        err = np.abs(gp[k].astype(np.float64) - wp[k])
        assert np.all(err <= bound), (k, float(np.max(err - bound)))


def test_make_job_reads_the_examples_env():
    for mod in EXAMPLES.values():
        job = mod.make_job({"TPUJOB_BATCH": "32", "TPUJOB_STEPS": "7",
                            "TPUJOB_STEPS_PER_CALL": "2"})
        assert job.total_steps == 7 and job.steps_per_call == 2
        b = job.make_batch(torch.Generator().manual_seed(0), 0)
        assert tuple(b["sparse"].shape) == (32, 26)
        default = mod.make_job({})
        assert default.total_steps == 100 and default.steps_per_call == 1
        assert default.make_batch(torch.Generator().manual_seed(0),
                                  0)["label"].shape == (512,)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_examples_train_through_run_training_on_cpu(name):
    """Two steps of the example's job at its full widths (DEFAULT_CONFIG:
    26 slots x 10,000 ids, MLP 400-400-400), a batch of 64, on the CPU."""
    job = dataclasses.replace(
        EXAMPLES[name].make_job({"TPUJOB_BATCH": "64", "TPUJOB_STEPS": "2"}),
        device="cpu", log_every=1)
    out = run_training(job)
    assert out["steps"] == 2 and np.isfinite(out["loss"])
    params = out["state"]["params"]
    table = "embed" if name == "wide_deep" else "fm_embed"
    assert tuple(params[table]["table"].shape) == (260_000, 16)


_DP_WORKER = '''
import dataclasses, json, sys, torch
from paddle_operator_tpu_torch import bridge
from paddle_operator_tpu_torch.examples import train_wide_deep
from paddle_operator_tpu_torch.models import wide_deep
from paddle_operator_tpu_torch.runner import run_training

TINY = %r
job = train_wide_deep.make_job({"TPUJOB_BATCH": "64", "TPUJOB_STEPS": "3"})
job = dataclasses.replace(
    job, device="cpu", log_every=1,
    init_params=lambda gen: wide_deep.init(gen, TINY),
    loss_fn=lambda p, b: wide_deep.loss_fn(p, b, dtype=torch.float32),
    make_batch=lambda gen, step: wide_deep.synthetic_batch(gen, 64, TINY))
out = run_training(job)
flat = torch.cat([t.reshape(-1) for t in
                  bridge.leaves(out["state"]["params"])])
json.dump({"loss": out["loss"], "mesh": out["mesh_history"],
           "params": flat.tolist()}, open(sys.argv[1], "w"))
'''


def test_wide_deep_example_trains_data_parallel_under_launch(tmp_path):
    """The example's job (at TINY, fp32, on the CPU) under ``launch``
    with two gloo workers: a dp mesh of 2, the replicas bitwise equal,
    and the global batch's loss and parameters within 1e-5 of one
    process training on it alone."""
    script = tmp_path / "worker.py"
    script.write_text(_DP_WORKER % (TINY,))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = free_port()

    def start(rank, world):
        env = dict(os.environ, PYTHONPATH=repo, TPUJOB_NUM_WORKERS=str(world),
                   TPUJOB_WORKER_ID=str(rank),
                   TPUJOB_COORDINATOR="localhost:%d" % port,
                   TPUJOB_DIST_BACKEND="gloo")
        return subprocess.Popen(
            [sys.executable, "-m", "paddle_operator_tpu_torch.launch",
             str(script), str(tmp_path / ("w%d_%d.json" % (world, rank)))],
            cwd=repo, env=env, stderr=subprocess.PIPE, text=True)

    procs = [start(0, 2), start(1, 2), start(0, 1)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    r0, r1, one = (json.load(open(tmp_path / n))
                   for n in ("w2_0.json", "w2_1.json", "w1_0.json"))
    assert r0["mesh"] == [{"dp": 2}] and one["mesh"] == [None]
    assert r0["params"] == r1["params"] and r0["loss"] == r1["loss"]
    assert abs(r0["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
    np.testing.assert_allclose(r0["params"], one["params"], rtol=0,
                               atol=1e-5)
