"""MoE across worker processes in the torch port: global routing under dp
and sp, and expert parallelism over an ``ep`` mesh axis with the
reference's rules, in four real worker processes (``python -m
paddle_operator_tpu_torch.launch`` with the operator's env, gloo on the
CPU), against the JAX package's GSPMD programs on the conftest's CPU
devices.

One world of four workers (``paddle_operator_tpu_torch/moe_check.py``)
runs every scenario of this file while JAX computes its references:

* (1) each rank's ``(gate, choice, global position, keep)`` and aux term
  under dp2 (``{"dp": 2, "ep": 2}``: the ep pairs hold the same tokens),
  sp2 (``{"ep": 2, "sp": 2}``) and dp2 x sp2, against JAX ``_route`` on
  the global batch: integers exact, the gate and the aux loss (the mean
  over dp of the sum over sp of the ranks' terms) within 2e-5. The
  capacity factor is 0.5, so tokens drop and a per-rank capacity would
  show;
* (2) ``moe_apply`` dense, and fused on the kernels' plain versions, on
  ``{"dp": 2, "ep": 2}`` with each rank's two of the four experts,
  forward within 2e-5 and gradients by the reference's MoE class
  (``tests/test_fused_ops.py``: 1e-4 for ``wi``/``wo``, 1e-3 for the
  router and the input), against JAX ``moe_apply`` on the global batch;
* (3) GPT and BERT TINY_MOE, one fp32 step on ``{"dp": 2, "ep": 2}``
  with ``gpt_rules() + moe_rules()`` / ``bert_rules() + moe_rules()``
  and ``grad_clip=1.0``, against the JAX mesh step: loss within 1e-5,
  the state within 1e-4 (expert leaves against their slice), replicated
  leaves bitwise equal on every rank and each expert shard bitwise equal
  on its two dp replicas (the counterparts of ``tests/test_gpt.py::
  test_moe_variant_trains`` and ``tests/test_pipeline_moe.py::
  test_bert_moe_ep_train_step``, at two experts a rank);
* (4) ``examples/train_gpt.make_job`` with ``TPUJOB_SP=2,
  TPUJOB_MOE_EXPERTS=4`` through ``run_training`` (bf16, remat, ring
  attention over dp2 x sp2), two steps, against the reference's job
  (``examples/train_gpt.py``'s loss and rules) on the JAX dp2 x sp2
  mesh from the same parameters and batches: losses within the bf16
  class below, replicas bitwise;
* (6) a ``{"dp": 2, "ep": 2}`` run's checkpoint (each ep tile written
  with its offset) restored into dp4 and into one process;
* (7) each planted fault of ``moe_check.FAULTS`` rejected: per-rank
  positions and capacity, the ep sum left out of the dispatched tokens'
  cotangent, the clip's norm without the ep sum.

(5), the rule tables and ``shard_tree``'s choice against the reference's,
needs no world.
"""

import concurrent.futures
import functools
import os

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge, dp_check, moe_check
from paddle_operator_tpu_torch.data import step_generator
from paddle_operator_tpu_torch.examples import train_gpt
from paddle_operator_tpu_torch.models import gpt as tgpt
from paddle_operator_tpu_torch.ops import optim as topt
from paddle_operator_tpu_torch.parallel import build_train_step
from paddle_operator_tpu_torch.parallel import sharding as tsharding
from paddle_operator_tpu_torch.runner import run_training
from paddle_operator_tpu_torch.utils import checkpoint as tckpt

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from paddle_operator_tpu.models import bert as jbert  # noqa: E402
from paddle_operator_tpu.models import gpt as jgpt  # noqa: E402
from paddle_operator_tpu.ops import moe as jmoe  # noqa: E402
from paddle_operator_tpu.ops import optim as jopt  # noqa: E402
from paddle_operator_tpu.parallel import context as jctx  # noqa: E402
from paddle_operator_tpu.parallel import mesh as jmesh  # noqa: E402
from paddle_operator_tpu.parallel import sharding as jsharding  # noqa: E402
from paddle_operator_tpu.parallel import train as jtrain  # noqa: E402

KEY = jax.random.PRNGKey(0)
FWD_TOL = 2e-5
EXPERT_TOL, ROUTER_TOL = 1e-4, 1e-3
LOSS_RTOL, STATE_TOL = 1e-5, 1e-4
#: the bf16 job (4): |loss(port) - loss(JAX)| / loss at each step. Both
#: run bf16 compute on fp32 parameters, rounding each matmul and
#: layernorm to bf16 in their own order: the two steps read 5.3e-5 and
#: 2.2e-4 on the CPU
JOB_RTOL = 1e-3
ROUTE_MESHES = {"dp2": {"dp": 2, "ep": 2}, "sp2": {"ep": 2, "sp": 2},
                "dp2sp2": {"dp": 2, "sp": 2}}
EP_MESH = {"dp": 2, "ep": 2}
#: (B, S, D, E, mlp) of the routing and moe_apply checks
B, S, D, E, MLP = 4, 16, 16, 4, 32
ROUTE_CF, MOE_CF = 0.5, 1.0
#: examples/train_gpt.make_job's env of (4)
JOB_ENV = {"TPUJOB_SP": "2", "TPUJOB_MOE_EXPERTS": "4",
           "TPUJOB_LAYERS": "2", "TPUJOB_HIDDEN": "64", "TPUJOB_HEADS": "2",
           "TPUJOB_MLP_DIM": "128", "TPUJOB_VOCAB": "128",
           "TPUJOB_SEQ": "64", "TPUJOB_BATCH": "4", "TPUJOB_STEPS": "2"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _block(x, rank, mesh_axes):
    """Rank ``rank``'s block of a global ``[B, S, ...]`` array (rank =
    row-major over the mesh axes in dict order)."""
    coords, rest = {}, rank
    for name, n in reversed(list(mesh_axes.items())):
        coords[name], rest = rest % n, rest // n
    dp, sp = mesh_axes.get("dp", 1), mesh_axes.get("sp", 1)
    rows = x.shape[0] // dp
    cols = x.shape[1] // sp
    i, j = coords.get("dp", 0), coords.get("sp", 0)
    return x[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols]


def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmesh.make_mesh(axes, jax.devices()[:n])


def _jax_step(model, tree, batch):
    mod = {"gpt": jgpt, "bert": jbert}[model]
    rules = ((jsharding.gpt_rules() if model == "gpt"
              else jsharding.bert_rules()) + jsharding.moe_rules())
    opt = jopt.adamw(1e-3, weight_decay=0.01,
                     wd_mask=jopt.make_wd_mask(tree))
    loss = lambda p, b: mod.loss_fn(p, b, dtype=jnp.float32)  # noqa: E731
    step, state = jtrain.build_train_step(
        loss, opt, jax.tree_util.tree_map(jnp.asarray, tree),
        jax.tree_util.tree_map(jnp.asarray, batch), mesh=_jax_mesh(EP_MESH),
        rules=rules, grad_clip=1.0, cache=False)
    state, m = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "state": _np(state)}


def _jax_moe(tree, x):
    """JAX moe_apply (dense, fp32) on the global batch: output, aux and
    the gradients of the mean squared row sum plus aux."""
    def loss(p, x):
        out, aux = jmoe.moe_apply(p, x, capacity_factor=MOE_CF,
                                  dtype=jnp.float32, fused=False)
        return (jnp.mean(jnp.sum(out ** 2, -1)) + aux["moe_aux_loss"],
                (out, aux["moe_aux_loss"]))

    (_, (out, aux)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    return {"out": np.asarray(out), "aux": float(aux), "dx": np.asarray(gx),
            "grads": _np(gp)}


def _job_inputs():
    """The port job's parameters (seed 0) and its two global batches, as
    run_training draws them on the CPU."""
    job = train_gpt.make_job(JOB_ENV)
    params = job.init_params(torch.Generator().manual_seed(job.seed))
    batches = [job.make_batch(step_generator(job.seed, i, "cpu"), i)
               for i in range(2)]
    return bridge.params_to_numpy(params), [bridge.params_to_numpy(b)
                                            for b in batches]


def _jax_job(tree, batches):
    """The reference's examples/train_gpt.py job on the JAX dp2 x sp2
    mesh: its loss (remat, ring attention over sp, ce_chunk 1024, bf16),
    rules, adamw schedule and clip, from ``tree``, per-step losses."""
    mesh = _jax_mesh({"dp": 2, "sp": 2})
    attn = functools.partial(jctx.ring_attention, mesh=mesh, axis="sp",
                             causal=True)
    loss = lambda p, b: jgpt.loss_fn(p, b, remat=True,  # noqa: E731
                                     attn_impl=attn, ce_chunk=1024)
    steps = int(JOB_ENV["TPUJOB_STEPS"])
    opt = jopt.adamw(jopt.cosine_schedule(3e-4, steps, steps // 10),
                     weight_decay=0.1)
    step, state = jtrain.build_train_step(
        loss, opt, jax.tree_util.tree_map(jnp.asarray, tree),
        jax.tree_util.tree_map(jnp.asarray, batches[0]), mesh=mesh,
        rules=jsharding.gpt_rules() + jsharding.moe_rules(),
        seq_axis="sp", grad_clip=1.0, cache=False)
    losses = []
    for b in batches:
        state, m = step(state, jax.tree_util.tree_map(jnp.asarray, b))
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    out = str(tmp)
    rng = np.random.default_rng(3)
    moe_tree = _np(jmoe.moe_init(KEY, D, MLP, E))
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    trees = {"moe": moe_tree, "x": {"x": x}}
    for model, mod, batch in (
            ("gpt", jgpt, lambda k: jgpt.synthetic_batch(k, 4, 32, 1024)),
            ("bert", jbert, lambda k: jbert.synthetic_batch(k, 8, 16, 1024))):
        trees[model] = _np(mod.init(KEY, mod.TINY_MOE_CONFIG))
        trees[model + "_batch"] = _np(batch(jax.random.PRNGKey(1)))
    for name, t in trees.items():
        dp_check.save_tree(os.path.join(out, name + ".npz"), t)
    path = lambda name: os.path.join(out, name + ".npz")  # noqa: E731
    scenarios = []
    for name, axes in ROUTE_MESHES.items():
        scenarios.append({"kind": "route", "name": "route_" + name,
                          "mesh": axes, "tree": path("moe"), "x": path("x"),
                          "capacity_factor": ROUTE_CF})
    scenarios.append({"kind": "route", "name": "route_fault",
                      "mesh": ROUTE_MESHES["dp2sp2"], "tree": path("moe"),
                      "x": path("x"), "capacity_factor": ROUTE_CF,
                      "fault": "route_per_rank"})
    for name, extra in (("moe_dense", {}), ("moe_fused", {"fused": True}),
                        ("moe_fault", {"fault": "ep_x_cotangent"})):
        scenarios.append(dict({"kind": "moe", "name": name, "mesh": EP_MESH,
                               "tree": path("moe"), "x": path("x"),
                               "capacity_factor": MOE_CF}, **extra))
    for model in ("gpt", "bert"):
        scenarios.append({"kind": "step", "name": "step_" + model,
                          "model": model, "mesh": EP_MESH,
                          "tree": path(model), "batch": path(model + "_batch"),
                          "clip": 1.0})
    scenarios.append({"kind": "step", "name": "step_fault", "model": "gpt",
                      "mesh": EP_MESH, "tree": path("gpt"),
                      "batch": path("gpt_batch"), "clip": 1.0,
                      "fault": "norm_without_ep"})
    ckpt = os.path.join(out, "ckpt")
    scenarios.append({"kind": "run", "name": "save_dp2_ep2", "steps": 2,
                      "mesh": EP_MESH, "ckpt": ckpt})
    scenarios.append({"kind": "restore", "name": "restore_dp4",
                      "mesh": {"dp": 4}, "ckpt": ckpt})
    scenarios.append({"kind": "job", "name": "job", "env": JOB_ENV})
    job_tree, job_batches = _job_inputs()
    ref = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        workers = pool.submit(moe_check.launch,
                              {"out": out, "scenarios": scenarios}, world=4,
                              timeout=500, env={"OMP_NUM_THREADS": "2"})
        ref["route"] = jmoe._route(moe_tree, jnp.asarray(x), ROUTE_CF)
        ref["moe"] = _jax_moe(moe_tree, x)
        for model in ("gpt", "bert"):
            ref["step_" + model] = _jax_step(model, trees[model],
                                             trees[model + "_batch"])
        ref["job"] = _jax_job(job_tree, job_batches)
        workers.result()
    got = {sc["name"]: [dp_check.load_tree(os.path.join(
        out, "%s.rank%d.npz" % (sc["name"], r))) for r in range(4)]
        for sc in scenarios}
    return {"got": got, "ref": ref, "ckpt": ckpt, "trees": trees}


def _route_parts(got, ref, axes):
    """Rank by rank, got against the reference's global routing: the
    integers' mismatches (a capacity counts as one), the gate's largest
    error, and the aux loss (the mean over dp of the sum over sp)."""
    gate, choice, pos, cap, aux = (np.asarray(v) if i < 4 else v
                                   for i, v in enumerate(ref))
    glob = {k: v.reshape(B, S) for k, v in (("gate", gate),
                                            ("choice", choice),
                                            ("pos", pos))}
    glob["keep"] = glob["pos"] < int(cap)
    bad, gate_err = 0, 0.0
    for r, g in enumerate(got):
        bad += int(int(g["capacity"]) != int(cap))
        for k in ("choice", "pos", "keep"):
            bad += int(np.sum(_block(glob[k], r, axes).reshape(-1)
                              != g[k]))
        gate_err = max(gate_err, float(np.max(np.abs(
            _block(glob["gate"], r, axes).reshape(-1) - g["gate"]))))
    dp = axes.get("dp", 1)
    ep = axes.get("ep", 1)
    aux_got = sum(float(g["aux"]) for g in got) / (dp * ep)
    return bad, gate_err, aux_got, float(aux["moe_aux_loss"])


@pytest.mark.parametrize("mesh", sorted(ROUTE_MESHES))
def test_routing_matches_jax_on_the_global_batch(world, mesh):
    bad, gate_err, aux_got, aux_want = _route_parts(
        world["got"]["route_" + mesh], world["ref"]["route"],
        ROUTE_MESHES[mesh])
    assert bad == 0
    assert gate_err <= FWD_TOL
    assert abs(aux_got - aux_want) <= FWD_TOL * abs(aux_want)
    # tokens drop at this capacity factor
    assert int(np.sum(np.asarray(world["ref"]["route"][2])
                      >= world["ref"]["route"][3])) > 0


def test_per_rank_routing_is_rejected(world):
    bad, _, _, _ = _route_parts(world["got"]["route_fault"],
                                world["ref"]["route"],
                                ROUTE_MESHES["dp2sp2"])
    assert bad > 0


def _moe_errors(got, ref):
    """Largest errors of the ranks' moe_apply against JAX's: forward,
    aux, dx, router, wi and wo (relative to the largest reference
    magnitude, as ``np.testing.assert_allclose`` with atol = rtol
    would)."""
    def err(a, b):
        return float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))

    out = {"out": 0.0, "dx": 0.0, "router": 0.0, "wi": 0.0, "wo": 0.0}
    for r, g in enumerate(got):
        out["out"] = max(out["out"], err(g["out"], _block(ref["out"], r,
                                                          EP_MESH)))
        # each rank's loss is its block's: the global loss is their mean
        # over dp, so its input gradient is half the rank's
        out["dx"] = max(out["dx"], err(g["dx"] / 2,
                                       _block(ref["dx"], r, EP_MESH)))
        out["router"] = max(out["router"], err(
            g["d_router_kernel"], ref["grads"]["router"]["kernel"]))
        k = r % 2
        for w in ("wi", "wo"):
            out[w] = max(out[w], err(g["d_" + w],
                                     ref["grads"][w][2 * k:2 * k + 2]))
    out["aux"] = abs(sum(float(g["aux"]) for g in got) / 4 - ref["aux"])
    return out


@pytest.mark.parametrize("name", ["moe_dense", "moe_fused"])
def test_moe_apply_on_dp2_ep2_matches_jax(world, name):
    e = _moe_errors(world["got"][name], world["ref"]["moe"])
    assert e["out"] <= FWD_TOL and e["aux"] <= FWD_TOL
    assert e["wi"] <= EXPERT_TOL and e["wo"] <= EXPERT_TOL
    assert e["router"] <= ROUTER_TOL and e["dx"] <= ROUTER_TOL


def test_ep_sum_left_out_of_the_token_cotangent_is_rejected(world):
    e = _moe_errors(world["got"]["moe_fault"], world["ref"]["moe"])
    assert e["dx"] > ROUTER_TOL
    assert e["out"] <= FWD_TOL


def _state_error(got_state, want_state, ep_index):
    """Largest |got - want| / max(1, |want|) over the leaves, the expert
    leaves against block ``ep_index`` of the whole."""
    want = bridge.flatten(want_state)
    worst = 0.0
    for k, v in bridge.flatten(got_state).items():
        w = np.asarray(want[k])
        if v.shape != w.shape:
            n = v.shape[0]
            w = w[ep_index * n:(ep_index + 1) * n]
        worst = max(worst, float(np.max(np.abs(v - w))
                                 / max(1.0, np.max(np.abs(w)))))
    return worst


@pytest.mark.parametrize("model", ["gpt", "bert"])
def test_moe_step_on_dp2_ep2_with_rules_matches_jax(world, model):
    got, ref = world["got"]["step_" + model], world["ref"]["step_" + model]
    for r, g in enumerate(got):
        assert abs(float(g["loss"]) - ref["loss"]) <= LOSS_RTOL * abs(
            ref["loss"])
        assert abs(float(g["grad_norm"]) - ref["grad_norm"]) <= \
            LOSS_RTOL * ref["grad_norm"]
        assert _state_error(g["state"], ref["state"], r % 2) <= STATE_TOL
        assert float(g["moe_aux"]) > 0
    # replicas: the replicated leaves bitwise on every rank, each expert
    # shard bitwise on its two dp replicas (ranks r and r + 2)
    assert len({str(g["dense_digest"]) for g in got}) == 1
    assert str(got[0]["expert_digest"]) == str(got[2]["expert_digest"])
    assert str(got[1]["expert_digest"]) == str(got[3]["expert_digest"])
    assert str(got[0]["expert_digest"]) != str(got[1]["expert_digest"])
    wi = bridge.flatten(got[0]["state"])["params/layers/0/moe/wi"]
    assert wi.shape[0] == tgpt.TINY_MOE_CONFIG["moe_experts"] // 2


def test_norm_without_the_ep_sum_is_rejected(world):
    got = world["got"]["step_fault"]
    norms = [float(g["grad_norm"]) for g in got]
    assert norms[0] != norms[1]
    # the ep ranks clip by different norms: their replicated leaves part
    assert str(got[0]["dense_digest"]) != str(got[1]["dense_digest"])
    assert abs(norms[0] - world["ref"]["step_gpt"]["grad_norm"]) > \
        LOSS_RTOL * world["ref"]["step_gpt"]["grad_norm"]


def test_make_job_moe_under_sp_matches_jax(world):
    """(4): the job's losses (each rank reports the replica's: the sum
    over sp, averaged over dp) against the reference's job on the JAX
    mesh; every rank ends with the same state."""
    got, ref = world["got"]["job"], world["ref"]["job"]
    for g in got:
        assert str(g["mesh_history"]) == '[{"dp": 2, "sp": 2}]'
    # the ranks' losses are their parts: average over the ranks, times sp
    losses = np.mean([g["losses"] for g in got], axis=0) * 2
    assert len(losses) == 2
    for a, b in zip(losses, ref):
        assert abs(a - b) <= JOB_RTOL * abs(b), (losses, ref)
    want = bridge.flatten(got[0]["state"])
    for g in got[1:]:
        for k, v in bridge.flatten(g["state"]).items():
            assert np.array_equal(v, want[k]), k


def _whole(states):
    """The whole state from ranks 0 and 1 of a dp2 x ep2 run (ep 0 and
    1 of dp 0): the expert leaves joined along their leading axis."""
    a, b = bridge.flatten(states[0]), bridge.flatten(states[1])
    return {k: (np.concatenate([v, b[k]])
                if k.endswith("moe/wi") or k.endswith("moe/wo") else v)
            for k, v in a.items()}


def test_dp2_ep2_checkpoint_restores_into_dp4_and_one_process(world):
    saved = [g["state"] for g in world["got"]["save_dp2_ep2"]]
    whole = _whole(saved)
    assert whole["params/layers/0/moe/wi"].shape[0] == \
        tgpt.TINY_MOE_CONFIG["moe_experts"]
    for g in world["got"]["restore_dp4"]:
        got = bridge.flatten(g["state"])
        assert sorted(got) == sorted(whole)
        for k, v in whole.items():
            assert np.array_equal(got[k], v), k
    restored, manifest = tckpt.restore_checkpoint(world["ckpt"], step=2)
    assert manifest["format"] == "sharded"
    for k, v in bridge.flatten(restored).items():
        assert np.array_equal(np.asarray(v), whole[k]), k
    job = moe_check.tiny_moe_job(3, None, world["ckpt"])
    out = run_training(job)
    assert out["resume_steps"] == [2] and out["steps"] == 3
    assert out["mesh_history"] == [None] and np.isfinite(out["loss"])


@pytest.mark.parametrize("table", ["gpt_rules", "bert_rules", "moe_rules",
                                   "resnet_rules", "ctr_rules"])
def test_rule_tables_match_the_reference(table):
    got = getattr(tsharding, table)()
    want = getattr(jsharding, table)()
    assert [(rx, tuple(spec)) for rx, spec in got] == \
        [(rx, tuple(spec)) for rx, spec in want]


@pytest.mark.parametrize("axes", [{"dp": 2, "ep": 4}, {"dp": 8},
                                  {"dp": 2, "tp": 4}, {"ep": 8},
                                  {"dp": 4, "ep": 2}])
@pytest.mark.parametrize("model", ["gpt", "bert"])
def test_shard_tree_choice_matches_the_reference(axes, model):
    mod = {"gpt": jgpt, "bert": jbert}[model]
    tree = _np(mod.init(KEY, dict(mod.TINY_MOE_CONFIG, moe_experts=6)))
    rules = ((jsharding.gpt_rules() if model == "gpt"
              else jsharding.bert_rules()) + jsharding.moe_rules())
    want = {k: tuple(sh.spec) for k, sh in bridge.flatten(
        jsharding.shard_tree(tree, _jax_mesh(axes), rules)).items()}
    trules = ((tsharding.gpt_rules() if model == "gpt"
               else tsharding.bert_rules()) + tsharding.moe_rules())
    assert tsharding.shard_tree(tree, axes, trules) == want


def test_ep_slice_cuts_the_expert_leaves():
    tree = _np(jgpt.init(KEY, jgpt.TINY_MOE_CONFIG))
    for k in range(2):
        got = bridge.flatten(bridge.ep_slice(tree, k, 2))
        for path, v in bridge.flatten(tree).items():
            if path.endswith("moe/wi") or path.endswith("moe/wo"):
                assert np.array_equal(got[path], v[2 * k:2 * k + 2])
            else:
                assert got[path] is v


def test_rules_on_a_mesh_without_ep_keep_every_leaf_whole():
    """A mesh without an ep axis keeps every leaf whole; the rules' tp
    entries are dropped on a mesh without tp."""
    from paddle_operator_tpu_torch.parallel.mesh import make_mesh

    tree = _np(jgpt.init(KEY, jgpt.TINY_MOE_CONFIG))
    params = bridge.params_from_numpy(tree, device="cpu")
    batch = bridge.params_from_numpy(_np(jgpt.synthetic_batch(KEY, 2, 16,
                                                              1024)), "cpu")
    step, state = build_train_step(
        lambda p, b: tgpt.loss_fn(p, b, dtype=torch.float32),
        topt.adamw(1e-3), params, batch, mesh=make_mesh({"dp": 1}),
        rules=tsharding.gpt_rules() + tsharding.moe_rules())
    assert step.layout == {}
    assert state["params"]["layers"][0]["moe"]["wi"].shape[0] == 4
    state, m = step(state, batch)
    assert np.isfinite(float(m["loss"]))
