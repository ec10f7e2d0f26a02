"""Tensor parallelism in the torch port: the reference's ``gpt_rules``,
``bert_rules`` and ``resnet_rules`` honoured by the train step over tp
and fsdp, in four real worker processes (``python -m
paddle_operator_tpu_torch.launch`` with the operator's env, gloo on the
CPU), against the JAX package's GSPMD programs on the conftest's CPU
devices.

One world of four workers (``paddle_operator_tpu_torch/tp_check.py``)
runs every scenario of this file while JAX computes its references.
Every scenario starts from a JAX-initialised tree whose biases are set to
non-zero randoms (a bias of a row-parallel layer added on every rank is
invisible at zero):

* (2) GPT and BERT TINY, one fp32 step with ``grad_clip=1.0`` on
  ``{"dp": 2, "tp": 2}`` and ``{"tp": 4}``, against the JAX mesh step
  with the same rules: loss within 1e-5, the state within 1e-4 (each
  tile against its slice), replicated leaves bitwise equal on every rank
  and each tile bitwise equal on its dp replicas. BERT's vocabulary is
  1022: split at tp 2, whole at tp 4 (the rule falls back), while its
  attention and MLP are split. The port's counterparts of
  ``tests/test_parallel.py::test_bert_train_step_dp_tp_convergence`` and
  ``test_tp_matches_single_device_loss`` (whose 2e-2 is far looser);
* (3) ResNet-18 (10 classes) on ``{"dp": 2, "fsdp": 2}`` with
  ``resnet_rules()``, its classifier split by columns, against the JAX
  mesh step;
* (4) ``steps_per_call=2`` and a step built with ``init_state=False`` on
  the live state, on dp2 x tp2, as ``tests/test_parallel.py:172, :200``
  build them, against two JAX mesh steps; the state-less build also on
  tp4, where BERT's vocabulary leaves are whole, and refused there
  without the build's layout;
* (5) ``examples/train_gpt.make_job`` through ``run_training`` on dp2 x
  tp2 (bf16, remat, the chunked head), two steps, against the
  reference's job on the JAX mesh;
* (6) a dp2 x tp2 run's checkpoint restored into tp4, into dp4 and into
  one process; the shard-wise restore opens only the tiles a rank's
  blocks overlap; the JAX package's reader assembles the port's tiles;
  a lost tile fails the coverage check;
* (7) each planted fault of ``tp_check.CPU_FAULTS`` rejected.

(1), the rule choice and the tiles against the reference's
``NamedSharding`` specs and ``addressable_shards``, needs no world.
"""

import concurrent.futures
import json
import os
import shutil

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge, dp_check, tp_check
from paddle_operator_tpu_torch.data import step_generator
from paddle_operator_tpu_torch.examples import train_gpt
from paddle_operator_tpu_torch.parallel import sharding as tsharding
from paddle_operator_tpu_torch.runner import run_training
from paddle_operator_tpu_torch.utils import checkpoint as tckpt

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from paddle_operator_tpu.models import bert as jbert  # noqa: E402
from paddle_operator_tpu.models import gpt as jgpt  # noqa: E402
from paddle_operator_tpu.models import resnet as jres  # noqa: E402
from paddle_operator_tpu.ops import optim as jopt  # noqa: E402
from paddle_operator_tpu.parallel import mesh as jmesh  # noqa: E402
from paddle_operator_tpu.parallel import sharding as jsharding  # noqa: E402
from paddle_operator_tpu.parallel import train as jtrain  # noqa: E402
from paddle_operator_tpu.utils import checkpoint as jckpt  # noqa: E402

KEY = jax.random.PRNGKey(0)
LOSS_RTOL, STATE_TOL = 1e-5, 1e-4
#: the bf16 job (5): |loss(port) - loss(JAX)| / loss at each step, the
#: class of ``tests/test_torch_moe_ep.py``'s job: both run bf16 compute
#: on fp32 parameters and round each matmul and layernorm in their own
#: order
JOB_RTOL = 1e-3
MESHES = {"dp2tp2": {"dp": 2, "tp": 2}, "tp4": {"tp": 4},
          "dp2fsdp2": {"dp": 2, "fsdp": 2}}
#: BERT TINY with a vocabulary that divides by 2 but not by 4
BERT_CFG = dict(jbert.TINY_CONFIG, vocab_size=1022)
RESNET = {"depth": 18, "classes": 10, "image": 32, "batch": 8}
#: examples/train_gpt.make_job's env of (5)
JOB_ENV = {"TPUJOB_LAYERS": "2", "TPUJOB_HIDDEN": "64", "TPUJOB_HEADS": "2",
           "TPUJOB_MLP_DIM": "128", "TPUJOB_VOCAB": "128",
           "TPUJOB_SEQ": "64", "TPUJOB_BATCH": "4", "TPUJOB_STEPS": "2"}
FAULT_MODEL = {"fsdp_gather_slice": ("resnet", "dp2fsdp2")}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _coords(rank, axes):
    """Rank ``rank``'s index along each axis (row-major, dict order)."""
    out, rest = {}, rank
    for name, n in reversed(list(axes.items())):
        out[name], rest = rest % n, rest // n
    return out


def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmesh.make_mesh(axes, jax.devices()[:n])


def _rules(model, jax_side=False):
    mod = jsharding if jax_side else tsharding
    return {"gpt": mod.gpt_rules, "bert": mod.bert_rules,
            "resnet": mod.resnet_rules}[model]()


def _with_biases(tree, seed):
    """``tree`` with every bias leaf set to N(0, 0.1) from ``seed``."""
    rng = np.random.default_rng(seed)
    flat = bridge.flatten(tree)
    for k, v in flat.items():
        if k.endswith("bias"):
            flat[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    return bridge.unflatten(bridge.structure(tree), flat)


def _inputs():
    """Trees and batches of the step scenarios, JAX-initialised."""
    out = {
        "gpt": _with_biases(_np(jgpt.init(KEY, jgpt.TINY_CONFIG)), 1),
        "bert": _with_biases(_np(jbert.init(KEY, BERT_CFG)), 2),
        "resnet": _with_biases(_np(jres.init(
            KEY, depth=RESNET["depth"], num_classes=RESNET["classes"])), 3),
    }
    for i in range(2):
        k = jax.random.PRNGKey(10 + i)
        out["gpt_batch%d" % i] = _np(jgpt.synthetic_batch(k, 4, 32, 1024))
        out["bert_batch%d" % i] = _np(jbert.synthetic_batch(
            k, 4, 16, BERT_CFG["vocab_size"]))
        img = _np(jres.synthetic_batch(k, RESNET["batch"], RESNET["image"],
                                       RESNET["classes"]))
        # bf16 images as fp32 (the same values; npz holds no bfloat16)
        img["image"] = img["image"].astype(np.float32)
        out["resnet_batch%d" % i] = img
    return out


def _jax_steps(model, tree, batches, axes, windows=False):
    """The JAX mesh step on ``axes`` with the model's rules, clip 1.0 for
    GPT and BERT: the losses, the clip norms and the state after
    ``batches`` (two steps of one ``steps_per_call=2`` call when
    ``windows``)."""
    mod = {"gpt": jgpt, "bert": jbert, "resnet": jres}[model]
    if model == "resnet":
        opt = jopt.sgd(0.01, momentum=0.9, weight_decay=1e-4,
                       wd_mask=jopt.make_wd_mask(tree))
    else:
        opt = jopt.adamw(1e-3, weight_decay=0.01,
                         wd_mask=jopt.make_wd_mask(tree))
    loss = lambda p, b: mod.loss_fn(p, b, dtype=jnp.float32)  # noqa: E731
    j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    k = 2 if windows else 1
    step, state = jtrain.build_train_step(
        loss, opt, j(tree), j(batches[0]), mesh=_jax_mesh(axes),
        rules=_rules(model, True), cache=False, steps_per_call=k,
        grad_clip=None if model == "resnet" else 1.0,
        merge_stats=jres.merge_stats if model == "resnet" else None)
    if windows:
        batches = [jax.tree_util.tree_map(lambda *xs: np.stack(xs),
                                          *batches)]
    losses, norms = [], []
    for b in batches:
        state, m = step(state, j(b))
        losses += np.asarray(m["loss"]).reshape(-1).tolist()
        if "grad_norm" in m:
            norms += np.asarray(m["grad_norm"]).reshape(-1).tolist()
    return {"losses": losses, "grad_norms": norms, "state": _np(state)}


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
    """The reference's examples/train_gpt.py job on the JAX dp2 x tp2
    mesh: its loss (remat, ce_chunk 1024, bf16), rules, adamw schedule
    and clip, from ``tree``; per-step losses."""
    loss = lambda p, b: jgpt.loss_fn(p, b, remat=True,  # noqa: E731
                                     ce_chunk=1024)
    steps = int(JOB_ENV["TPUJOB_STEPS"])
    opt = jopt.adamw(jopt.cosine_schedule(3e-4, steps, steps // 10),
                     weight_decay=0.1)
    step, state = jtrain.build_train_step(
        loss, opt, jax.tree_util.tree_map(jnp.asarray, tree),
        jax.tree_util.tree_map(jnp.asarray, batches[0]),
        mesh=_jax_mesh(MESHES["dp2tp2"]),
        rules=jsharding.gpt_rules() + jsharding.moe_rules(),
        grad_clip=1.0, cache=False)
    losses = []
    for b in batches:
        state, m = step(state, jax.tree_util.tree_map(jnp.asarray, b))
        losses.append(float(m["loss"]))
    return losses


def _step_sc(name, model, mesh, path, **kw):
    calls = 2 if (kw.get("windows") or kw.get("stateless")) else 1
    return dict({"kind": "step", "name": name, "model": model,
                 "mesh": MESHES[mesh], "tree": path(model),
                 "batches": [path("%s_batch%d" % (model, i))
                             for i in range(calls)],
                 "clip": None if model == "resnet" else 1.0}, **kw)


#: the state-less builds: BERT's vocabulary split (dp2 x tp2) and fallen
#: back to whole (tp4)
STATELESS = [("step_bert_stateless", "dp2tp2"),
             ("step_bert_stateless_tp4", "tp4")]
STEPS = [("gpt", "dp2tp2"), ("gpt", "tp4"), ("bert", "dp2tp2"),
         ("bert", "tp4"), ("resnet", "dp2fsdp2")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    out = str(tmp)
    trees = _inputs()
    for name, t in trees.items():
        dp_check.save_tree(os.path.join(out, name + ".npz"), t)
    path = lambda name: os.path.join(out, name + ".npz")  # noqa: E731
    scenarios = [_step_sc("step_%s_%s" % (m, mesh), m, mesh, path)
                 for m, mesh in STEPS]
    scenarios += [_step_sc("step_bert_windows", "bert", "dp2tp2", path,
                           windows=True),
                  _step_sc("step_bert_stateless", "bert", "dp2tp2", path,
                           stateless=True),
                  _step_sc("step_bert_stateless_tp4", "bert", "tp4", path,
                           stateless=True)]
    for fault in tp_check.CPU_FAULTS:
        model, mesh = FAULT_MODEL.get(fault, ("gpt", "dp2tp2"))
        scenarios.append(_step_sc("fault_" + fault, model, mesh, path,
                                  fault=fault))
    ckpt = os.path.join(out, "ckpt")
    scenarios += [
        {"kind": "run", "name": "save_dp2tp2", "steps": 2,
         "mesh": MESHES["dp2tp2"], "ckpt": ckpt},
        {"kind": "restore", "name": "restore_tp4", "mesh": MESHES["tp4"],
         "ckpt": ckpt},
        {"kind": "restore", "name": "restore_dp4", "mesh": {"dp": 4},
         "ckpt": ckpt},
        {"kind": "job", "name": "job", "env": JOB_ENV,
         "mesh": MESHES["dp2tp2"]}]
    job_tree, job_batches = _job_inputs()
    ref = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        workers = pool.submit(tp_check.launch,
                              {"out": out, "scenarios": scenarios}, world=4,
                              timeout=600, env={"OMP_NUM_THREADS": "2"})
        for m, mesh in STEPS:
            ref["step_%s_%s" % (m, mesh)] = _jax_steps(
                m, trees[m], [trees[m + "_batch0"]], MESHES[mesh])
        two = [trees["bert_batch0"], trees["bert_batch1"]]
        ref["step_bert_windows"] = _jax_steps("bert", trees["bert"], two,
                                              MESHES["dp2tp2"], windows=True)
        for name, mesh in STATELESS:
            ref[name] = _jax_steps("bert", trees["bert"], two, MESHES[mesh])
        ref["job"] = _jax_job(job_tree, job_batches)
        workers.result()
    got = {sc["name"]: [dp_check.load_tree(os.path.join(
        out, "%s.rank%d.npz" % (sc["name"], r))) for r in range(4)]
        for sc in scenarios}
    return {"got": got, "ref": ref, "ckpt": ckpt, "scenarios": {
        sc["name"]: sc for sc in scenarios}}


# ---------------------------------------------------------------------------
# (1) the rule choice and the tiles
# ---------------------------------------------------------------------------

def _jax_tree(model):
    if model == "gpt":
        return _np(jgpt.init(KEY, jgpt.TINY_CONFIG))
    if model == "bert":
        return _np(jbert.init(KEY, BERT_CFG))
    return _np(jres.init(KEY, depth=18, num_classes=10))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("model", ["gpt", "bert", "resnet"])
def test_rule_choice_and_tiles_match_the_reference(model, mesh):
    """``shard_tree``'s choice and :func:`tile_of`'s blocks of every leaf
    against the reference's ``NamedSharding`` specs and each device's
    ``addressable_shards`` index (rank = the device's row-major place on
    the mesh)."""
    axes = MESHES[mesh]
    tree = _jax_tree(model)
    jm = _jax_mesh(axes)
    shardings = bridge.flatten(jsharding.shard_tree(tree, jm,
                                                    _rules(model, True)))
    got = tsharding.shard_tree(tree, axes, _rules(model))
    assert got == {k: tuple(sh.spec) for k, sh in shardings.items()}
    place = {d.id: i for i, d in enumerate(jm.devices.reshape(-1))}
    split = 0
    for k, leaf in bridge.flatten(tree).items():
        arr = jax.device_put(jnp.asarray(leaf), shardings[k])
        for shard in arr.addressable_shards:
            tile = tsharding.tile_of(got[k], axes,
                                     _coords(place[shard.device.id], axes))
            want = [[0 if s.start is None else s.start,
                     d if s.stop is None else s.stop]
                    for s, d in zip(shard.index, leaf.shape)]
            assert tckpt.tile_slices(leaf.shape, tile) == want, k
            split += bool(tile)
    assert (split > 0) == ((model == "resnet") == (mesh == "dp2fsdp2"))
    if model == "bert" and mesh == "tp4":
        # 1022 divides by 2, not by 4: the vocabulary's leaves fall back
        for k in ("embed/tok/table", "mlm/decoder/kernel",
                  "mlm/decoder/bias"):
            assert got[k] == (), k
        assert got["layers/0/attn/q/kernel"] == (None, "tp", None)


def test_tile_of_counts_row_major_over_an_entry_of_several_axes():
    """``P(("dp", "tp"))``: the block index runs over dp, then tp, as the
    reference's devices lie."""
    axes = {"dp": 2, "tp": 4}
    jm = _jax_mesh(axes)
    from jax.sharding import NamedSharding, PartitionSpec as P
    arr = jax.device_put(jnp.zeros((16, 3)),
                         NamedSharding(jm, P(("dp", "tp"), None)))
    place = {d.id: i for i, d in enumerate(jm.devices.reshape(-1))}
    for shard in arr.addressable_shards:
        tile = tsharding.tile_of((("dp", "tp"), None), axes,
                                 _coords(place[shard.device.id], axes))
        assert tile[0][0] * 2 == shard.index[0].start and tile[0][1] == 8


# ---------------------------------------------------------------------------
# (2)-(4) the train step against the JAX mesh step
# ---------------------------------------------------------------------------

def _state_error(got_state, want_state, axes, rank, model):
    """Largest |got - want| / max(1, |want|) over the leaves, each tile
    against its slice of the whole leaf."""
    want = bridge.flatten(want_state)
    specs = tsharding.shard_tree(want_state, axes, _rules(model))
    coords = _coords(rank, axes)
    worst = 0.0
    for k, v in bridge.flatten(got_state).items():
        w = np.asarray(tsharding.cut(np.asarray(want[k]), tsharding.tile_of(
            specs[k], axes, coords)))
        assert v.shape == w.shape, k
        worst = max(worst, float(np.max(np.abs(v - w), initial=0.0)
                                 / max(1.0, np.max(np.abs(w), initial=0.0))))
    return worst


def _step_problems(got, ref, axes, model):
    """The gates a step scenario fails: the loss and the clip norm within
    LOSS_RTOL on every rank, the state within STATE_TOL, the replicated
    leaves bitwise on every rank, each tile bitwise on its dp replicas."""
    problems = []
    for r, g in enumerate(got):
        for key in ("losses", "grad_norms"):
            for a, b in zip(np.asarray(g.get(key, [])).reshape(-1),
                            ref[key]):
                if not abs(float(a) - b) <= LOSS_RTOL * abs(b):
                    problems.append("%s rank %d: %r, want %r" % (key, r, a, b))
        err = _state_error(g["state"], ref["state"], axes, r, model)
        if not err <= STATE_TOL:
            problems.append("state rank %d off by %g" % (r, err))
    if len({str(g["replicated"]) for g in got}) != 1:
        problems.append("replicated leaves differ between ranks")
    dp = axes.get("dp", 1)
    per = len(got) // dp
    for r in range(per):
        if len({str(got[r + i * per]["tiles"]) for i in range(dp)}) != 1:
            problems.append("tiles of %d differ on their dp replicas" % r)
    return problems


@pytest.mark.parametrize("model,mesh", STEPS)
def test_one_fp32_step_matches_jax(world, model, mesh):
    name = "step_%s_%s" % (model, mesh)
    got, ref = world["got"][name], world["ref"][name]
    assert _step_problems(got, ref, MESHES[mesh], model) == []
    split = [str(p) for p in got[0]["split"]]
    if mesh == "dp2fsdp2":
        assert split == ["opt/momentum/head/fc/kernel",
                         "params/head/fc/kernel"]
        kernel = bridge.flatten(got[0]["state"])["params/head/fc/kernel"]
        assert kernel.shape == (512, RESNET["classes"] // 2)
    else:
        n = MESHES[mesh]["tp"]
        assert "params/layers/0/mlp/fc2/kernel" in split
        q = bridge.flatten(got[0]["state"])["params/layers/0/attn/q/kernel"]
        assert q.shape[1] == 4 // n
        vocab = "params/embed/tok/table" in split
        assert vocab == (model == "gpt" or n == 2)


@pytest.mark.parametrize("name,mesh", [("step_bert_windows", "dp2tp2")]
                         + STATELESS)
def test_windows_and_the_stateless_build_match_jax(world, name, mesh):
    """On tp4 BERT's vocabulary leaves fall back to whole: the stateless
    build takes them from the build's layout, not from their shapes."""
    got, ref = world["got"][name], world["ref"][name]
    assert len(ref["losses"]) == 2 and len(got[0]["losses"]) == 2
    assert _step_problems(got, ref, MESHES[mesh], "bert") == []
    split = {str(p) for p in got[0]["split"]}
    assert ("params/embed/tok/table" in split) == (mesh == "dp2tp2")


def test_a_stateless_build_under_tp_needs_the_build_layout():
    """A live tp4 state's shapes cannot tell a tile from a leaf whose rule
    fell back: BERT's 1022-row table read as a tile of 4088 rows would
    divide by 4. Without ``tiles`` the state-less build refuses."""
    from paddle_operator_tpu_torch.models import bert as tbert
    from paddle_operator_tpu_torch.ops import optim as topt
    from paddle_operator_tpu_torch.parallel import build_train_step
    from paddle_operator_tpu_torch.parallel.mesh import make_mesh

    params = bridge.params_from_numpy(_jax_tree("bert"), "cpu")
    batch = bridge.params_from_numpy(_np(jbert.synthetic_batch(
        KEY, 4, 16, BERT_CFG["vocab_size"])), "cpu")
    mesh = make_mesh(MESHES["tp4"], world=4)
    args = (tbert.loss_fn, topt.adamw(1e-3), params, batch)
    with pytest.raises(ValueError, match="layout"):
        build_train_step(*args, mesh=mesh, rules=tsharding.bert_rules(),
                         init_state=False)
    step, _ = build_train_step(*args, mesh=mesh,
                               rules=tsharding.bert_rules())
    assert "params/embed/tok/table" not in step.layout
    assert "params/layers/0/attn/q/kernel" in step.layout


def test_make_job_on_dp2_tp2_matches_jax(world):
    """(5): the example's job, its losses against the reference's job on
    the JAX mesh; the replicas end bitwise equal."""
    got, ref = world["got"]["job"], world["ref"]["job"]
    for g in got:
        assert str(g["mesh_history"]) == '[{"dp": 2, "tp": 2}]'
    # each rank's loss is its dp block's, the same on its tp ranks: the
    # global batch's is their mean
    assert np.array_equal(got[0]["losses"], got[1]["losses"])
    losses = np.mean([g["losses"] for g in got], axis=0)
    assert len(losses) == 2
    for a, b in zip(losses, ref):
        assert abs(a - b) <= JOB_RTOL * abs(b), (losses, ref)
    for r in (0, 1):
        want = bridge.flatten(got[r]["state"])
        for k, v in bridge.flatten(got[r + 2]["state"]).items():
            assert np.array_equal(v, want[k]), k


# ---------------------------------------------------------------------------
# (6) checkpoints
# ---------------------------------------------------------------------------

def _whole(states):
    """The whole state of a dp2 x tp2 run from ranks 0 and 1 (tp 0 and 1
    of dp 0): each split leaf joined along the dimension its rule splits
    (the rules' choice on the job's whole state)."""
    job = tp_check.tiny_job(1, None, "")
    params = job.init_params(torch.Generator().manual_seed(0))
    specs = tsharding.shard_tree(
        {"params": params, "opt": job.optimizer.init(params)},
        MESHES["dp2tp2"], tsharding.gpt_rules())
    a, b = bridge.flatten(states[0]), bridge.flatten(states[1])
    out = {}
    for k, v in a.items():
        dims = list(tsharding.split_axes(specs[k]))
        out[k] = np.concatenate([v, b[k]], axis=dims[0]) if dims else v
    return out


def test_dp2_tp2_checkpoint_restores_into_tp4_dp4_and_one_process(world):
    saved = [g["state"] for g in world["got"]["save_dp2tp2"]]
    whole = _whole(saved)
    assert whole["params/lm_head/kernel"].shape == (128, 1024)
    axes = MESHES["tp4"]
    specs = tsharding.shard_tree(whole, axes, tsharding.gpt_rules())
    for r, g in enumerate(world["got"]["restore_tp4"]):
        got = bridge.flatten(g["state"])
        assert sorted(got) == sorted(whole)
        for k, v in whole.items():
            want = tsharding.cut(v, tsharding.tile_of(specs[k], axes,
                                                      _coords(r, axes)))
            assert np.array_equal(got[k], want), k
    for g in world["got"]["restore_dp4"]:
        got = bridge.flatten(g["state"])
        for k, v in whole.items():
            assert np.array_equal(got[k], v), k
    restored, manifest = tckpt.restore_checkpoint(world["ckpt"], step=2)
    assert manifest["format"] == "sharded"
    for k, v in bridge.flatten(restored).items():
        assert np.array_equal(np.asarray(v), whole[k]), k
    out = run_training(tp_check.tiny_job(3, None, world["ckpt"]))
    assert out["resume_steps"] == [2] and out["steps"] == 3
    assert out["mesh_history"] == [None] and np.isfinite(out["loss"])


def test_shard_wise_restore_opens_only_the_overlapping_tiles(world):
    """A tp4 rank's block of a leaf split over tp2 lies in one saved tile
    (tile r // 2): it opens that one file a leaf; a dp4 rank, holding
    whole leaves, opens both."""
    with open(os.path.join(world["ckpt"], "step_%012d" % 2,
                           "shards.json")) as f:
        index = json.load(f)
    split = {k for k, e in index.items() if len(e["shards"]) == 2}
    assert "params/layers/0/attn/q/kernel" in split
    for r, g in enumerate(world["got"]["restore_tp4"]):
        opened = [str(p) for p in g["opened"]]
        assert len(opened) == len(index)
        for k in split:
            stem = k.replace("/", "__")
            assert [p for p in opened if p.startswith(stem + ".s")] == \
                ["%s.s%d.npy" % (stem, r // 2)], k
    for g in world["got"]["restore_dp4"]:
        assert len(g["opened"]) == len(index) + len(split)


def test_jax_reads_the_ports_tiles(world):
    want = _whole([g["state"] for g in world["got"]["save_dp2tp2"]])
    got, manifest = jckpt.restore_checkpoint(world["ckpt"], step=2)
    assert manifest["step"] == 2
    for k, v in bridge.flatten(_np(got)).items():
        assert np.array_equal(v, want[k]), k


def test_a_lost_tile_fails_the_coverage_check(world, tmp_path):
    src = os.path.join(world["ckpt"], "step_%012d" % 2)
    dst = tmp_path / "ckpt"
    shutil.copytree(src, str(dst / ("step_%012d" % 2)))
    path = dst / ("step_%012d" % 2) / "shards.json"
    index = json.loads(path.read_text())
    index["params/layers/0/mlp/fc1/kernel"]["shards"].pop()
    path.write_text(json.dumps(index))
    with pytest.raises(tckpt.CorruptCheckpointError, match="coverage"):
        tckpt.restore_checkpoint(str(dst), step=2)
    layout = {"params/layers/0/mlp/fc1/kernel": tsharding.LeafTile(
        {1: (0, 2)}, ("tp",))}
    with pytest.raises(tckpt.CorruptCheckpointError, match="coverage"):
        tckpt.restore_tiles(str(dst), layout, step=2)


# ---------------------------------------------------------------------------
# (7) planted faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault", tp_check.CPU_FAULTS)
def test_planted_fault_is_rejected(world, fault):
    model, mesh = FAULT_MODEL.get(fault, ("gpt", "dp2tp2"))
    got = world["got"]["fault_" + fault]
    ref = world["ref"]["step_%s_%s" % (model, mesh)]
    assert _step_problems(got, ref, MESHES[mesh], model) != []
