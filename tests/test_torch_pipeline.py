"""Pipeline parallelism in the torch port: GPipe over a ``pp`` axis
(``paddle_operator_tpu_torch/parallel/pipeline.py``) in four real worker
processes (``python -m paddle_operator_tpu_torch.launch`` with the
operator's env, gloo on the CPU), against the JAX package's
``pipeline_apply`` on the conftest's CPU devices.

One world of four workers (``paddle_operator_tpu_torch/pp_check.py``)
runs every scenario of this file while JAX computes its references, all
in fp32:

* the reference tests' two-layer ReLU stage
  (``tests/test_pipeline_moe.py::mlp_stage``) on ``{"pp": 4}`` with 4
  and 8 microbatches (the reference's mesh is ``{"pp": 4, "dp": 2}`` on
  its eight devices): outputs within 1e-5; and on ``{"pp": 2, "dp":
  2}`` with the gradients of ``sum(out ** 2)`` with respect to the
  stacked tree (whole, and each rank's block) and the input: within
  1e-4;
* GPT TINY at 4 layers as 2 stages of 2 blocks (the embedding, the final
  LayerNorm and the LM head on every rank) on ``{"pp": 2, "dp": 2}``,
  both packages' ``pipeline_apply`` around their own ``_block``: loss
  within 1e-5, gradients of the whole tree within 1e-4;
* ``shard_stacked_params`` against the reference's
  ``addressable_shards``; ``stack_stage_params`` against its leaves;
* the planted faults of ``pp_check.FAULTS`` rejected;
* ``make_mesh`` and ``mesh_from_env`` with ``pp``, and the train step's
  refusal of a ``pp`` axis above 1.
"""

import concurrent.futures
import json
import os

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge, dp_check, pp_check
from paddle_operator_tpu_torch.models import gpt as tgpt
from paddle_operator_tpu_torch.ops import optim as topt
from paddle_operator_tpu_torch.parallel import build_train_step
from paddle_operator_tpu_torch.parallel import pipeline as tpipe
from paddle_operator_tpu_torch.parallel.mesh import make_mesh, \
    mesh_from_env

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from paddle_operator_tpu.models import gpt as jgpt  # noqa: E402
from paddle_operator_tpu.ops import nn as jnn  # noqa: E402
from paddle_operator_tpu.parallel import mesh as jmesh  # noqa: E402
from paddle_operator_tpu.parallel import pipeline as jpipe  # noqa: E402

KEY = jax.random.PRNGKey(0)
OUT_TOL, GRAD_TOL, LOSS_RTOL = 1e-5, 1e-4, 1e-5
DIM, BATCH = 16, 16
PP4, PP2DP2 = {"pp": 4}, {"pp": 2, "dp": 2}
#: the reference's mesh of the forward checks, on its eight devices
JAX_PP4 = {"pp": 4, "dp": 2}
GPT_CFG = dict(jgpt.TINY_CONFIG, layers=4)
GPT_BATCH, GPT_SEQ, GPT_MICRO = 4, 32, 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmesh.make_mesh(axes, jax.devices()[:n])


def jax_mlp_stage(params, x):
    h = jnp.maximum(x @ params["w1"], 0.0)
    return h @ params["w2"]


def _stages(n, dim=DIM):
    out = []
    for i in range(n):
        k1, k2 = jax.random.split(jax.random.fold_in(KEY, i))
        out.append({"w1": jax.random.normal(k1, (dim, dim)) * 0.1,
                    "w2": jax.random.normal(k2, (dim, dim)) * 0.1})
    return out


def _jax_mlp(stacked, x, axes, n_micro, grad):
    mesh = _jax_mesh(axes)
    run = lambda s, x: jpipe.pipeline_apply(  # noqa: E731
        s, x, jax_mlp_stage, mesh, n_microbatches=n_micro)
    s, x = jax.tree_util.tree_map(jnp.asarray, stacked), jnp.asarray(x)
    if not grad:
        return {"out": np.asarray(run(s, x))}
    (loss, out), grads = jax.value_and_grad(
        lambda s, x: (jnp.sum(run(s, x) ** 2), run(s, x)), argnums=(0, 1),
        has_aux=True)(s, x)
    return {"out": np.asarray(out), "loss": float(loss),
            "grads": {"stacked": _np(grads[0]), "x": np.asarray(grads[1])}}


def _gpt_split(tree, n_stages):
    k = len(tree["layers"]) // n_stages
    rest = {key: v for key, v in tree.items() if key != "layers"}
    stages = jpipe.stack_stage_params(
        [tree["layers"][s * k:(s + 1) * k] for s in range(n_stages)])
    return {"rest": rest, "stages": stages}


def _jax_gpt(tree, batch, axes):
    """The reference's GPT blocks through its ``pipeline_apply``, the
    embedding, final LayerNorm and dense LM head around it, fp32."""
    mesh = _jax_mesh(axes)
    f32 = jnp.float32

    def stage_fn(blocks, x):
        for layer in blocks:
            x, _ = jgpt._block(layer, x, f32, "auto", None)
        return x

    def loss(t):
        ids = jnp.asarray(batch["input_ids"])
        x = jnn.embedding(t["rest"]["embed"]["tok"], ids, f32)
        x = jpipe.pipeline_apply(t["stages"], x, stage_fn, mesh,
                                 n_microbatches=GPT_MICRO)
        h = jnn.layernorm(t["rest"]["final_ln"], x, dtype=f32)
        logits = jnn.dense(t["rest"]["lm_head"], h[:, :-1], dtype=f32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        picked = jnp.take_along_axis(logp, ids[:, 1:, None], axis=-1)
        return -jnp.mean(picked)

    t = jax.tree_util.tree_map(
        jnp.asarray, _gpt_split(tree, axes["pp"]))
    value, grads = jax.value_and_grad(loss)(t)
    return {"loss": float(value), "grads": _np(grads)}


def _mlp_sc(name, mesh, path, n_micro, **kw):
    return dict({"kind": "mlp", "name": name, "mesh": mesh,
                 "stacked": path("stacked%d" % mesh["pp"]), "x": path("x"),
                 "n_micro": n_micro}, **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pp"))
    path = lambda name: os.path.join(out, name + ".npz")  # noqa: E731
    stages = {n: _stages(n) for n in (2, 4)}
    trees = {"stacked%d" % n: _np(jpipe.stack_stage_params(s))
             for n, s in stages.items()}
    trees["x"] = {"x": np.asarray(jax.random.normal(KEY, (BATCH, DIM)))}
    trees["gpt"] = _np(jgpt.init(KEY, GPT_CFG))
    trees["gpt_batch"] = _np(jgpt.synthetic_batch(
        jax.random.PRNGKey(1), GPT_BATCH, GPT_SEQ, GPT_CFG["vocab_size"]))
    for name, t in trees.items():
        dp_check.save_tree(path(name), t)
    scenarios = [
        _mlp_sc("mlp_pp4_m4", PP4, path, 4),
        _mlp_sc("mlp_pp4_m8", PP4, path, 8),
        _mlp_sc("grad_whole", PP2DP2, path, 4, grad=True),
        _mlp_sc("grad_local", PP2DP2, path, 4, grad=True, form="local"),
        {"kind": "gpt", "name": "gpt", "mesh": PP2DP2, "tree": path("gpt"),
         "batch": path("gpt_batch"), "n_micro": GPT_MICRO},
        {"kind": "shard", "name": "shard", "mesh": PP4,
         "stacked": path("stacked4")},
    ] + [_mlp_sc("fault_" + f, PP2DP2, path, 4, grad=True, fault=f)
         for f in pp_check.FAULTS]
    ref = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        workers = pool.submit(pp_check.launch,
                              {"out": out, "scenarios": scenarios}, world=4,
                              timeout=400, env={"OMP_NUM_THREADS": "2"})
        for m in (4, 8):
            ref["mlp_pp4_m%d" % m] = _jax_mlp(trees["stacked4"],
                                              trees["x"]["x"], JAX_PP4, m,
                                              grad=False)
        ref["grad"] = _jax_mlp(trees["stacked2"], trees["x"]["x"], PP2DP2,
                               4, grad=True)
        ref["gpt"] = _jax_gpt(trees["gpt"], trees["gpt_batch"], PP2DP2)
        workers.result()
    got = {sc["name"]: [dp_check.load_tree(os.path.join(
        out, "%s.rank%d.npz" % (sc["name"], r))) for r in range(4)]
        for sc in scenarios}
    return {"got": got, "ref": ref, "trees": trees}


def _max_err(got, want):
    g, w = bridge.flatten(got), bridge.flatten(want)
    assert sorted(g) == sorted(w)
    return max(float(np.max(np.abs(np.asarray(g[k]) - np.asarray(w[k])),
                            initial=0.0)) for k in g)


def _grad_problems(got, ref, local=False):
    """The gates of a gradient scenario: the output within OUT_TOL, the
    gradients within GRAD_TOL on every rank (with ``local``, each rank's
    block against its stage's), the loss within LOSS_RTOL."""
    problems = []
    for r, g in enumerate(got):
        want = ref["grads"]
        if local:
            stage = r // 2  # rank = pp * 2 + dp
            want = dict(want, stacked=jax.tree_util.tree_map(
                lambda a: a[stage:stage + 1], want["stacked"]))
        if not _max_err(g["out"], ref["out"]) <= OUT_TOL:
            problems.append("rank %d output" % r)
        if not _max_err(g["grads"], want) <= GRAD_TOL:
            problems.append("rank %d grads off by %g"
                            % (r, _max_err(g["grads"], want)))
        if not abs(float(g["loss"]) - ref["loss"]) <= LOSS_RTOL * abs(
                ref["loss"]):
            problems.append("rank %d loss" % r)
    return problems


# ---------------------------------------------------------------------------
# the pipeline against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_micro", [4, 8])
def test_pipeline_output_matches_the_reference(world, n_micro):
    name = "mlp_pp4_m%d" % n_micro
    want = world["ref"][name]["out"]
    for g in world["got"][name]:
        assert g["out"].shape == (BATCH, DIM)
        assert float(np.max(np.abs(g["out"] - want))) <= OUT_TOL


@pytest.mark.parametrize("n_micro", [4, 8])
def test_pipeline_matches_the_stages_in_sequence(world, n_micro):
    """The reference's ``test_pipeline_matches_sequential`` on the port:
    the pipeline's output is the four stages applied in turn (1e-4, the
    reference's bound)."""
    trees = world["trees"]
    x = torch.from_numpy(np.array(trees["x"]["x"]))
    stacked = bridge.params_from_numpy(trees["stacked4"], "cpu")
    for s in range(4):
        x = pp_check.mlp_stage(bridge.tree_map(lambda a: a[s], stacked), x)
    for g in world["got"]["mlp_pp4_m%d" % n_micro]:
        assert float(np.max(np.abs(g["out"] - x.numpy()))) <= 1e-4


@pytest.mark.parametrize("form", ["whole", "local"])
def test_pipeline_gradients_match_the_reference(world, form):
    """Whole stacked tree: every rank holds the whole gradient (each
    stage's block gathered over pp); this rank's block: its block's. The
    input's gradient sums the stages' (stage 0's alone is not zero)."""
    got = world["got"]["grad_" + form]
    assert _grad_problems(got, world["ref"]["grad"],
                          local=form == "local") == []
    assert np.abs(world["ref"]["grad"]["grads"]["x"]).max() > 0


def test_gpt_blocks_pipelined_match_the_reference(world):
    """GPT TINY at 4 layers, 2 stages of 2 blocks on pp2 x dp2: the loss
    and every leaf's gradient (the stacked blocks whole, the embedding,
    the final LayerNorm and the head) against the reference's
    ``pipeline_apply`` of its own ``_block``."""
    ref = world["ref"]["gpt"]
    for g in world["got"]["gpt"]:
        assert abs(float(g["loss"]) - ref["loss"]) <= LOSS_RTOL * abs(
            ref["loss"])
        assert _max_err(g["grads"], ref["grads"]) <= GRAD_TOL
    # the embedding's gradient is whole on every rank
    assert np.abs(bridge.flatten(world["got"]["gpt"][1]["grads"])[
        "rest/embed/tok/table"]).max() > 0


def test_one_process_runs_the_same_loss_in_sequence(world):
    """``gpt_pipeline_loss`` without a mesh (the chip phase's one-process
    reference) gives the pipelined loss."""
    tree = bridge.params_from_numpy(world["trees"]["gpt"], "cpu")
    batch = {k: torch.from_numpy(np.array(v)).long()
             for k, v in world["trees"]["gpt_batch"].items()}
    rest, stacked = pp_check.split_gpt(tree, 2)
    loss = pp_check.gpt_pipeline_loss({"rest": rest, "stages": stacked},
                                      batch, None, GPT_MICRO,
                                      dtype=torch.float32, ce_chunk=0)
    ref = world["ref"]["gpt"]["loss"]
    assert abs(float(loss) - ref) <= LOSS_RTOL * abs(ref)
    # and the sequential GPT of the model itself
    whole, _ = tgpt.loss_fn(tree, batch, dtype=torch.float32)
    assert abs(float(whole) - ref) <= LOSS_RTOL * abs(ref)


def test_shard_and_stack_match_the_reference(world):
    """``stack_stage_params`` stacks as the reference's does;
    ``shard_stacked_params`` gives each rank the block the reference's
    ``NamedSharding(mesh, P("pp"))`` puts on a device at its pp
    coordinate, the leading axis of 1 kept."""
    stages = _stages(4)
    got = tpipe.stack_stage_params(
        [bridge.params_from_numpy(_np(s), "cpu") for s in stages])
    want = _np(jpipe.stack_stage_params(stages))
    assert _max_err(bridge.params_to_numpy(got), want) == 0.0
    mesh = _jax_mesh(JAX_PP4)
    placed = jpipe.shard_stacked_params(
        jax.tree_util.tree_map(jnp.asarray, want), mesh)
    names = list(mesh.shape)
    by_pp = {}
    for k, arr in bridge.flatten(placed).items():
        for shard in arr.addressable_shards:
            where = np.argwhere(mesh.devices == shard.device)[0]
            pp = int(where[names.index("pp")])
            by_pp.setdefault(pp, {})[k] = np.asarray(shard.data)
    for r, g in enumerate(world["got"]["shard"]):
        assert json.loads(str(g["coords"])) == {"pp": r}
        blocks = bridge.flatten(g["blocks"])
        for k, v in by_pp[r].items():
            assert blocks[k].shape == (1, DIM, DIM)
            assert np.array_equal(blocks[k], v), k


@pytest.mark.parametrize("fault", pp_check.FAULTS)
def test_planted_fault_is_rejected(world, fault):
    assert _grad_problems(world["got"]["fault_" + fault],
                          world["ref"]["grad"]) != []


# ---------------------------------------------------------------------------
# the mesh and the train step
# ---------------------------------------------------------------------------

def test_make_mesh_and_mesh_from_env_take_pp(monkeypatch):
    for axes, n in (({"pp": 4}, 4), ({"pp": 4, "dp": 2}, 8),
                    ({"pp": 2, "dp": -1}, 8)):
        got = make_mesh(axes, world=n)
        want = dict(jmesh.make_mesh(axes, jax.devices()[:n]).shape)
        assert got.shape == want and got.axis_size("pp") == want["pp"]
    monkeypatch.setenv("TPUJOB_MESH", "pp=4,dp=2")
    mesh = mesh_from_env(world=8)
    assert mesh.shape == {"pp": 4, "dp": 2} and mesh.coords() == {
        "pp": 0, "dp": 0}
    monkeypatch.setenv("TPUJOB_DCN_MESH", "dp=2")
    with pytest.raises(NotImplementedError, match="A5.3"):
        mesh_from_env(world=8)


def test_the_train_step_refuses_pp_and_names_the_pipeline():
    """The reference's step only replicates over pp; the port's refuses
    the axis above 1 and names ``pipeline_apply``. pp of 1 builds."""
    params = tgpt.init(torch.Generator().manual_seed(0),
                       dict(tgpt.TINY_CONFIG, max_seq=16))
    batch = {"input_ids": torch.zeros((4, 16), dtype=torch.long)}
    args = (tgpt.loss_fn, topt.adamw(1e-3), params, batch)
    with pytest.raises(NotImplementedError, match="pipeline_apply"):
        build_train_step(*args, mesh=make_mesh({"pp": 2, "dp": 2},
                                               world=4))
    step, state = build_train_step(*args, mesh=make_mesh({"pp": 1,
                                                          "dp": 1}))
    assert state["params"]["lm_head"]["kernel"].shape == (128, 1024)


def test_a_stacked_tree_of_another_depth_is_refused():
    mesh = make_mesh({"pp": 1})
    stacked = {"w": torch.zeros((3, 2, 2))}
    with pytest.raises(ValueError, match="leading axes"):
        tpipe.pipeline_apply(stacked, torch.zeros((4, 2)),
                             lambda p, x: x @ p["w"], mesh, 2)
    with pytest.raises(ValueError, match="microbatches"):
        tpipe.pipeline_apply({"w": torch.zeros((1, 2, 2))},
                             torch.zeros((3, 2)), lambda p, x: x, mesh, 2)
