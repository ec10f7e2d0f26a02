"""Sequence-parallel GPT training of the torch port across four real
worker processes (``python -m paddle_operator_tpu_torch.launch`` with the
operator's env, gloo on the CPU) against the JAX package's
``build_train_step(mesh=..., seq_axis="sp")`` with ``ring_attention`` in
the loss, on the conftest's CPU devices.

One world of four workers (``paddle_operator_tpu_torch/dp_check.py``)
runs every scenario of this file. In fp32, GPT ``TINY_CONFIG`` (2
layers, 128 wide, adamw, ``grad_clip=1.0``), global batch 4 x 512:

* ``build_train_step(seq_axis="sp")`` on ``{"dp": 1, "sp": 4}`` (the
  mesh ``examples/train_gpt.py`` builds for four workers with
  ``TPUJOB_SP=4``) and on ``{"dp": 2, "sp": 2}``, three calls, each
  started from one port process's state before it (the reasons are
  ``tests/test_torch_dp.py``'s): losses within 1e-5 relative and the
  state after each call within 1e-4 (the classes of
  ``tests/test_torch_gpt_train.py`` and ``tests/test_torch_train.py``),
  and every rank's state equal bit for bit. The ring is the blockwise
  one on the CPU ("auto"), and the flash ring (the kernels' plain
  versions) on ``{"dp": 1, "sp": 4}``. 511 labels split 128 / 128 / 128
  / 127 over the blocks, and one case's loss mask leaves block 0 a fifth
  of its labels, so a per-block mean would show.
* Three planted faults must fall outside those classes: the ring's
  causal test on rotated hops reversed, rope at the block's local
  positions, and the gradients averaged over dp only (each sp rank
  keeping its block's part).
* ``run_training`` of ``examples/train_gpt.make_job`` with
  ``TPUJOB_SP=2`` on the four workers (a ``{"dp": 2, "sp": 2}`` mesh), 2
  steps: every rank ends with the same state, and the step it saves
  restores in the JAX package and resumes in one port process.
* ``bert.encode`` with the port's ring over ``{"dp": 2, "sp": 2}``
  against the JAX package's dense encoder, 1e-4
  (``tests/test_bert_context.py::test_bert_ring_matches_einsum``).
"""

import concurrent.futures
import functools
import os

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge, dp_check
from paddle_operator_tpu_torch.examples import train_gpt
from paddle_operator_tpu_torch.models import gpt as tgpt
from paddle_operator_tpu_torch.parallel import build_train_step
from paddle_operator_tpu_torch.runner import run_training
from paddle_operator_tpu_torch.utils import checkpoint as tckpt

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from paddle_operator_tpu.models import bert as jbert  # noqa: E402
from paddle_operator_tpu.models import gpt as jgpt  # noqa: E402
from paddle_operator_tpu.ops import optim as jopt  # noqa: E402
from paddle_operator_tpu.parallel import context as jctx  # noqa: E402
from paddle_operator_tpu.parallel import mesh as jmesh  # noqa: E402
from paddle_operator_tpu.parallel import train as jtrain  # noqa: E402
from paddle_operator_tpu.utils import checkpoint as jckpt  # noqa: E402

CALLS = 3
LOSS_RTOL, STATE_TOL = 1e-5, 1e-4
GPT_CFG = dict(jgpt.TINY_CONFIG)        # 2 layers, 128 wide
SEQ, BATCH = 512, 4
MESHES = {"sp4": {"dp": 1, "sp": 4}, "dp2sp2": {"dp": 2, "sp": 2}}
#: case -> (mesh, batches, the port's ring impl)
CASES = {"sp4": ("sp4", "plain", "auto"),
         "dp2sp2": ("dp2sp2", "plain", "auto"),
         "sp4_flash": ("sp4", "plain", "flash"),
         "sp4_mask": ("sp4", "mask", "auto")}
#: planted fault -> the sound case it is planted in
FAULTS = {"causal_flipped": "sp4_flash", "rope_local": "sp4",
          "skip_sp_grad_sum": "sp4"}
#: examples/train_gpt.make_job's env of the run_training case (bf16)
RUN_ENV = {"TPUJOB_SP": "2", "TPUJOB_LAYERS": "2", "TPUJOB_HIDDEN": "64",
           "TPUJOB_HEADS": "2", "TPUJOB_MLP_DIM": "128",
           "TPUJOB_VOCAB": "128", "TPUJOB_SEQ": "64", "TPUJOB_BATCH": "4",
           "TPUJOB_STEPS": "2"}


def _batches(kind, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(CALLS):
        b = {"input_ids": rng.integers(0, GPT_CFG["vocab_size"],
                                       (BATCH, SEQ)).astype(np.int32)}
        if kind == "mask":
            mask = np.ones((BATCH, SEQ), np.float32)
            mask[:, :SEQ // 4] = rng.random((BATCH, SEQ // 4)) < 0.2
            b["loss_mask"] = mask
        out.append(b)
    return out


def _port_chain(tree, calls):
    """One port process, no mesh, the whole sequence, the calls chained:
    host states (index 0 the initial state), where every side starts
    each call."""
    loss, opt, _, clip = dp_check.cpu_train_setup("gpt")
    step, state = build_train_step(
        loss, opt, bridge.params_from_numpy(tree, device="cpu"),
        bridge.params_from_numpy(calls[0], device="cpu"), grad_clip=clip)
    states = [bridge.params_to_numpy(state)]
    for b in calls:
        state, _ = step(state, bridge.params_from_numpy(b, device="cpu"))
        states.append(bridge.params_to_numpy(state))
    return states


def _jax_run(mesh_axes, tree, calls, starts):
    """JAX on a dp x sp mesh with ``seq_axis="sp"`` and causal ring
    attention, call i started from ``starts[i]``: losses and states."""
    n = int(np.prod(list(mesh_axes.values())))
    mesh = jmesh.make_mesh(mesh_axes, jax.devices()[:n])
    attn = functools.partial(jctx.ring_attention, mesh=mesh, axis="sp",
                             causal=True)
    loss = lambda p, b: jgpt.loss_fn(p, b, dtype=jnp.float32,  # noqa: E731
                                     attn_impl=attn)
    opt = jopt.adamw(jopt.cosine_schedule(3e-4, 3, 1), weight_decay=0.1)
    step, _ = jtrain.build_train_step(
        loss, opt, jax.tree_util.tree_map(jnp.asarray, tree),
        jax.tree_util.tree_map(jnp.asarray, calls[0]), mesh=mesh,
        seq_axis="sp", grad_clip=1.0, cache=False)
    losses, states = [], []
    for b, start in zip(calls, starts):
        state, m = step(jax.tree_util.tree_map(jnp.asarray, start),
                        jax.tree_util.tree_map(jnp.asarray, b))
        losses.append(float(m["loss"]))
        states.append(jax.tree_util.tree_map(np.array, state))
    return losses, states


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start states from one port process; then one four-worker world
    over every scenario while JAX runs the same calls from the same
    starts on its meshes."""
    tmp = tmp_path_factory.mktemp("sp")
    out = str(tmp / "out")
    os.makedirs(out)
    tree = jax.tree_util.tree_map(
        np.asarray, jgpt.init(jax.random.PRNGKey(0), GPT_CFG))
    tree_path = os.path.join(out, "gpt.npz")
    dp_check.save_tree(tree_path, tree)
    data = {kind: _batches(kind) for kind in ("plain", "mask")}
    starts, files = {}, {}
    for kind, calls in data.items():
        starts[kind] = _port_chain(tree, calls)[:-1]
        files[kind] = {"batches": [], "starts": []}
        for i, (b, st) in enumerate(zip(calls, starts[kind])):
            for key, t in (("batches", b), ("starts", st)):
                path = os.path.join(out, "%s.%s%d.npz" % (kind, key, i))
                dp_check.save_tree(path, t)
                files[kind][key].append(path)
    scenarios = []
    for name, (mesh, kind, impl) in CASES.items():
        scenarios.append(dict(kind="train", name=name, model="gpt",
                              tree=tree_path, mesh=MESHES[mesh],
                              seq_axis="sp", impl=impl, **files[kind]))
    for fault, case in FAULTS.items():
        sc = next(s for s in scenarios if s["name"] == case)
        scenarios.append(dict(sc, name=fault, fault=fault))
    scenarios.append({"kind": "sprun", "name": "sprun", "env": dict(
        RUN_ENV, TPUJOB_CHECKPOINT_DIR=str(tmp / "ckpt"))})
    bert_cfg = dict(jbert.TINY_CONFIG)
    bert_tree = jax.tree_util.tree_map(
        np.asarray, jbert.init(jax.random.PRNGKey(0), bert_cfg))
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0,
                                        bert_cfg["vocab_size"]))
    for name, t in (("bert", bert_tree), ("bert_ids", {"input_ids": ids})):
        dp_check.save_tree(os.path.join(out, name + ".npz"), t)
    scenarios.append({"kind": "bert", "name": "bert",
                      "mesh": MESHES["dp2sp2"],
                      "tree": os.path.join(out, "bert.npz"),
                      "batch": os.path.join(out, "bert_ids.npz")})
    for name, axes in (("mesh_dp2sp2", MESHES["dp2sp2"]),
                       ("mesh_sp4", {"sp": 4})):
        scenarios.append({"kind": "mesh", "name": name, "mesh": axes})
    ref = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        workers = pool.submit(
            dp_check.launch_workers, {"out": out, "scenarios": scenarios},
            world=4, backend="gloo", timeout=400,
            env={"OMP_NUM_THREADS": "2"})
        for mesh in MESHES:
            ref[mesh] = _jax_run(MESHES[mesh], tree, data["plain"],
                                 starts["plain"])
        ref["sp4_mask"] = _jax_run(MESHES["sp4"], tree, data["mask"],
                                   starts["mask"])
        ref["bert"], _ = jbert.encode(bert_tree, jnp.asarray(ids),
                                      dtype=jnp.float32)
    lines = {}
    for rank_lines in workers.result():
        for line in rank_lines:
            lines.setdefault(line["scenario"], []).append(line)
    return {"ref": ref, "out": out, "ckpt": str(tmp / "ckpt"),
            "lines": {k: sorted(v, key=lambda r: r["rank"])
                      for k, v in lines.items()}}


@functools.lru_cache(maxsize=None)
def _load(path):
    return dp_check.load_tree(path)


def _got(world, name):
    return [_load(os.path.join(world["out"], "%s.rank%d.npz" % (name, r)))
            for r in range(4)]


def _want(world, case):
    mesh, kind, _ = CASES[case]
    return world["ref"]["sp4_mask" if kind == "mask" else mesh]


def _state_close(got, want, tol=STATE_TOL):
    """Every leaf within ``tol`` of max(1, its largest magnitude)."""
    g, w = bridge.flatten(got), bridge.flatten(want)
    assert list(g) == list(w)
    for k in w:
        err = np.max(np.abs(np.asarray(w[k], np.float64) - g[k]))
        assert err <= tol * max(1.0, np.max(np.abs(w[k]))), (k, err)


def _matches(world, name, case=None):
    """Every rank against JAX's run of ``case`` (default ``name``), call
    by call: losses within LOSS_RTOL, states within STATE_TOL; and the
    four ranks' states bit for bit."""
    want_losses, want_states = _want(world, case or name)
    ranks = _got(world, name)
    for got in ranks:
        for want_l, got_l in zip(want_losses, got["losses"]):
            assert abs(float(got_l) - want_l) <= LOSS_RTOL * abs(want_l), (
                float(got_l), want_l)
        for want, state in zip(want_states, got["states"]):
            _state_close(state, want)
    for other in ranks[1:]:
        for a, b in zip(ranks[0]["states"], other["states"]):
            fa, fb = bridge.flatten(a), bridge.flatten(b)
            for k in fa:
                assert np.array_equal(fa[k], fb[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_sp_train_step_matches_jax_mesh(world, case):
    _matches(world, case)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_are_rejected(world, fault):
    with pytest.raises(AssertionError):
        _matches(world, fault, case=FAULTS[fault])


def test_run_training_sp_checkpoint_restores_everywhere(world):
    """Four workers with TPUJOB_SP=2: a dp2 x sp2 mesh, equal final
    states; the step they save reads back in the JAX package and resumes
    in one port process."""
    ranks = _got(world, "sprun")
    for r in ranks:
        assert [dict((k, int(v)) for k, v in m.items())
                for m in r["mesh_history"]] == [{"dp": 2, "sp": 2}]
        assert int(r["steps"]) == 2 and np.isfinite(float(r["loss"]))
    want = bridge.flatten(ranks[0]["state"])
    for r in ranks[1:]:
        got = bridge.flatten(r["state"])
        for k, v in want.items():
            assert np.array_equal(got[k], v), k
    assert tckpt.all_steps(world["ckpt"])[0] == 2
    ref, _ = jckpt.restore_checkpoint(world["ckpt"], step=2)
    got = bridge.flatten(jax.tree_util.tree_map(np.asarray, ref))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    job = train_gpt.make_job(dict(RUN_ENV, TPUJOB_SP="1", TPUJOB_STEPS="3",
                                  TPUJOB_CHECKPOINT_DIR=world["ckpt"]))
    job.device = "cpu"
    out = run_training(job)
    assert out["resume_steps"] == [2] and out["steps"] == 3
    assert out["mesh_history"] == [None] and np.isfinite(out["loss"])


def test_bert_ring_matches_einsum(world):
    """Rank r = 2 * dp + sp holds row dp of the batch and block sp of the
    sequence."""
    got = _got(world, "bert")
    rows = [np.concatenate([got[2 * d + s]["hidden"] for s in (0, 1)],
                           axis=1) for d in (0, 1)]
    np.testing.assert_allclose(np.concatenate(rows), world["ref"]["bert"],
                               atol=1e-4, rtol=1e-4)


def test_loss_blocks_add_up_to_the_whole_sequence():
    """In one process, with an attention that mixes no tokens (the
    identity on v), the four blocks' losses and accuracies under a
    sequence split sum to the whole sequence's, with a mask that leaves
    the blocks unequal label counts: the labels cross the block
    boundaries and the denominator is the whole sequence's."""
    from paddle_operator_tpu_torch.parallel import collectives

    gen = torch.Generator().manual_seed(0)
    params = tgpt.init(gen, dict(GPT_CFG, layers=1))
    batch = {"input_ids": torch.randint(0, 1024, (2, 64), generator=gen),
             "loss_mask": (torch.rand(2, 64, generator=gen) < 0.5).float()}

    def ident(q, k, v):
        return v

    def loss(fn=tgpt.loss_fn):
        return fn(params, batch, dtype=torch.float32, attn_impl=ident)

    whole, whole_aux = loss()
    total, acc = 0.0, 0.0
    orig = collectives.seq_block
    try:
        for i in range(4):
            collectives.seq_block = lambda i=i: (i, 4)
            part, aux = loss()
            total += float(part)
            acc += float(aux["accuracy"])
    finally:
        collectives.seq_block = orig
    assert abs(total - float(whole)) <= 1e-5 * abs(float(whole))
    assert abs(acc - float(whole_aux["accuracy"])) <= 1e-6


def test_mesh_axes_follow_the_reference_layout(world):
    """Rank = dp * 2 + sp on {"dp": 2, "sp": 2} (dp outermost, as the
    reference lays out devices): each axis's group holds the ranks that
    differ only along it, and a sum over it sees only them."""
    got = world["lines"]["mesh_dp2sp2"]
    for r in got:
        dp, sp = divmod(r["rank"], 2)
        assert r["coords"] == {"dp": dp, "sp": sp}
        assert r["dp"]["rank"] == dp and r["sp"]["rank"] == sp
        assert r["sp"]["ranks"] == [2 * dp, 2 * dp + 1]
        assert r["dp"]["ranks"] == [sp, sp + 2]
        assert r["sp"]["sum"] == 4 * dp + 1 and r["dp"]["sum"] == 2 * sp + 2
    for r in world["lines"]["mesh_sp4"]:
        assert r["coords"] == {"sp": r["rank"]}
        assert r["sp"]["ranks"] == [0, 1, 2, 3] and r["sp"]["sum"] == 6


def test_make_mesh_takes_sp_and_refuses_the_rest(monkeypatch):
    from paddle_operator_tpu_torch.parallel.mesh import PORTED_AXES, \
        make_mesh, mesh_from_env

    assert PORTED_AXES == ("dp", "sp", "ep", "tp", "fsdp", "pp")
    mesh = make_mesh({"dp": -1, "sp": 2}, world=4)
    assert mesh.shape == {"dp": 2, "sp": 2} and mesh.size == 4
    assert mesh.axis_size("sp") == 2 and mesh.axis_size("tp") == 1
    assert mesh.coords() == {"dp": 0, "sp": 0} and mesh.axis_group("sp") \
        is None
    assert dict(jmesh.make_mesh({"dp": -1, "sp": 2},
                                jax.devices()[:4]).shape) == mesh.shape
    with pytest.raises(NotImplementedError, match="shards over"):
        make_mesh({"dp": 2, "xp": 2}, world=4)
    for axis in ("tp", "fsdp", "pp"):
        assert make_mesh({"dp": 2, axis: 2}, world=4).axis_size(axis) == 2
    # ep builds (expert parallelism), laid out as the reference's mesh
    ep = make_mesh({"dp": 2, "ep": 2}, world=4)
    assert ep.shape == dict(jmesh.make_mesh({"dp": 2, "ep": 2},
                                            jax.devices()[:4]).shape)
    assert ep.axis_size("ep") == 2 and ep.coords() == {"dp": 0, "ep": 0}
    assert ep.group_over(["dp", "sp"]) is None and ep.group is None
    monkeypatch.setenv("TPUJOB_MESH", "dp=2,sp=2")
    assert mesh_from_env(world=4).shape == {"dp": 2, "sp": 2}


def test_make_job_builds_the_sp_job():
    """TPUJOB_SP > 1: the sp mesh, seq_axis and ring attention in the
    loss; with MoE too (the MoE layers route over the global batch)."""
    env = dict(RUN_ENV, TPUJOB_SP="4")
    job = train_gpt.make_job(env)
    assert job.mesh_axes == {"dp": -1, "sp": 4} and job.seq_axis == "sp"
    one = train_gpt.make_job(dict(env, TPUJOB_SP="1"))
    assert one.mesh_axes is None and one.seq_axis is None
    seen = []

    def fake_ring(q, k, v, mesh, axis, causal):
        seen.append((mesh, axis, causal))
        return v

    from paddle_operator_tpu_torch.parallel import context
    from paddle_operator_tpu_torch.parallel.mesh import Mesh

    orig = context.ring_attention
    context.ring_attention = fake_ring
    try:
        params = job.init_params(torch.Generator().manual_seed(0))
        batch = job.make_batch(torch.Generator().manual_seed(1), 0)
        mesh = Mesh({"dp": 1, "sp": 4})
        job.loss_fn(params, batch, mesh=mesh)
    finally:
        context.ring_attention = orig
    assert seen == [(mesh, "sp", True)] * 2
    moe = train_gpt.make_job(dict(env, TPUJOB_MOE_EXPERTS="4"))
    assert moe.mesh_axes == {"dp": -1, "sp": 4} and moe.seq_axis == "sp"
    layers = moe.init_params(torch.Generator().manual_seed(0))["layers"]
    assert "moe" in layers[0] and "mlp" in layers[1]


def test_moe_under_a_sequence_split_raises():
    """MoE under a sequence split no longer raises: block 0 of two runs
    its MoE layer on its half of the sequence at its global positions
    (the routing over the sp group's blocks is held against JAX in
    ``tests/test_torch_moe_ep.py``)."""
    from paddle_operator_tpu_torch.ops import moe as tmoe
    from paddle_operator_tpu_torch.parallel import collectives

    gen = torch.Generator().manual_seed(0)
    params = tgpt.init(gen, dict(tgpt.TINY_MOE_CONFIG, layers=1))
    batch = {"input_ids": torch.randint(0, 1024, (2, 64), generator=gen)}
    shapes = []
    route = tmoe._route

    def seen(p, x, *a):
        shapes.append(tuple(x.shape))
        return route(p, x, *a)

    orig = collectives.seq_block
    collectives.seq_block = lambda: (0, 2)
    tmoe._route = seen
    try:
        loss, aux = tgpt.loss_fn(params, batch, dtype=torch.float32)
    finally:
        collectives.seq_block = orig
        tmoe._route = route
    assert np.isfinite(float(loss)) and float(aux["moe_aux"]) > 0.0
    assert shapes == [(2, 32, 128)]


def test_bind_mesh_follows_the_signature():
    """A loss with a ``mesh`` keyword gets the live mesh (the runner's and
    the card recorder's one rule); any other is handed on as it is."""
    from paddle_operator_tpu_torch.runner import bind_mesh

    def with_mesh(params, batch, mesh=None):
        return mesh

    def without(params, batch):
        return None

    mesh = object()
    assert bind_mesh(with_mesh, mesh)(0, 0) is mesh
    assert bind_mesh(without, mesh) is without
    bound = bind_mesh(dp_check._Recorder(without), mesh)
    assert bound.keywords == {"mesh": mesh}


def test_the_port_imports_no_jax():
    """The sp path's modules import with torch alone."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import paddle_operator_tpu_torch.examples.train_gpt\n"
            "import paddle_operator_tpu_torch.parallel.context\n"
            "import paddle_operator_tpu_torch.dp_check\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'paddle_operator_tpu')]\n"
            "sys.exit(1 if bad else 0)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert subprocess.run([sys.executable, "-c", code], cwd=repo,
                          timeout=120).returncode == 0
