"""The model axes beside each other and beside sp in the torch port: tp or
fsdp with sp or ep, and MoE layers under tp, in real worker processes
(``python -m paddle_operator_tpu_torch.launch`` with the operator's env,
gloo on the CPU), against the JAX package's GSPMD train step on the
conftest's CPU devices. Every case is fp32 with ``grad_clip=1.0``,
adamw(1e-3) under the wd mask, and starts from a JAX-initialised tree:
losses and clip norms within 1e-5, the state within 1e-4 (each tile
against its slice), the replicated leaves bitwise equal on every rank
and each tile bitwise equal on the ranks that hold it.

* The reference's dry-run program 1 (``__graft_entry__.py:65-96``):
  BERT TINY with 4 experts in every layer, ``moe_rules() +
  bert_rules()``, ``seq_axis="sp"``, a batch of 2 x 32, on ``{"dp": 1,
  "tp": 2, "sp": 2, "ep": 2}``: eight workers against eight JAX CPU
  devices, two steps; the port's attention is the ring over sp on each
  rank's 2 heads, the reference's BERT's masked attention (the batch's
  attention mask is all ones).
* Four workers: GPT TINY and BERT TINY on ``{"tp": 2, "sp": 2}`` with
  ring attention and with Ulysses (2 heads a tp rank, sp 2); GPT TINY
  MoE on ``{"tp": 2, "ep": 2}`` and ``{"fsdp": 2, "ep": 2}``.
* Ulysses refuses heads a rank holds that do not divide by sp.
* The planted faults of ``tp_check.HYBRID_FAULTS`` rejected: (iv) the
  LayerNorms' gradients left unsummed over sp (tp x sp), (v) the MoE
  leaves taken for tiles over tp (tp x ep).
"""

import concurrent.futures
import json
import os

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge, dp_check, tp_check
from paddle_operator_tpu_torch.parallel import context
from paddle_operator_tpu_torch.parallel import sharding as tsharding
from paddle_operator_tpu_torch.parallel.mesh import make_mesh

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from paddle_operator_tpu.models import bert as jbert  # noqa: E402
from paddle_operator_tpu.models import gpt as jgpt  # noqa: E402
from paddle_operator_tpu.ops import optim as jopt  # noqa: E402
from paddle_operator_tpu.parallel import mesh as jmesh  # noqa: E402
from paddle_operator_tpu.parallel import sharding as jsharding  # noqa: E402
from paddle_operator_tpu.parallel import train as jtrain  # noqa: E402

KEY = jax.random.PRNGKey(0)
LOSS_RTOL, STATE_TOL = 1e-5, 1e-4
PROGRAM1 = {"dp": 1, "tp": 2, "sp": 2, "ep": 2}
TP2SP2, TP2EP2, FSDP2EP2 = ({"tp": 2, "sp": 2}, {"tp": 2, "ep": 2},
                            {"fsdp": 2, "ep": 2})
#: model -> its config (tiny): BERT's program-1 MoE, dense BERT and GPT,
#: GPT with 4 experts in every layer
CONFIGS = {"bert_moe": dict(jbert.TINY_CONFIG, moe_experts=4, moe_every=1),
           "bert": dict(jbert.TINY_CONFIG),
           "gpt": dict(jgpt.TINY_CONFIG),
           "gpt_moe": dict(jgpt.TINY_MOE_CONFIG)}
#: four-worker case -> (config, mesh, attention over sp)
CASES = {"gpt_tp2sp2_ring": ("gpt", TP2SP2, "ring"),
         "gpt_tp2sp2_ulysses": ("gpt", TP2SP2, "ulysses"),
         "bert_tp2sp2_ring": ("bert", TP2SP2, "ring"),
         "bert_tp2sp2_ulysses": ("bert", TP2SP2, "ulysses"),
         "gpt_moe_tp2ep2": ("gpt_moe", TP2EP2, None),
         "gpt_moe_fsdp2ep2": ("gpt_moe", FSDP2EP2, None)}
#: planted fault -> the sound case it is planted in
FAULT_CASE = {"ln_grad_unsummed_over_sp": "gpt_tp2sp2_ring",
              "moe_leaves_as_tp_tiles": "gpt_moe_tp2ep2"}
SEQ = 32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _model(name):
    return "bert" if name.startswith("bert") else "gpt"


def _jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmesh.make_mesh(axes, jax.devices()[:n])


def _jax_rules(model):
    if model == "bert":
        return jsharding.moe_rules() + jsharding.bert_rules()
    return jsharding.gpt_rules() + jsharding.moe_rules()


def _batches(name, n, batch):
    mod = {"bert": jbert, "gpt": jgpt}[_model(name)]
    vocab = CONFIGS[name]["vocab_size"]
    return [_np(mod.synthetic_batch(jax.random.PRNGKey(10 + i), batch, SEQ,
                                    vocab)) for i in range(n)]


def _jax_steps(name, tree, batches, axes):
    """The reference's train step on ``axes``: the dry run's build (its
    rules, ``seq_axis="sp"`` where the mesh has sp, adamw(1e-3) under
    the wd mask, clip 1.0) in fp32; losses, clip norms, final state."""
    mod = {"bert": jbert, "gpt": jgpt}[_model(name)]
    j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    params = j(tree)
    opt = jopt.adamw(1e-3, wd_mask=jopt.make_wd_mask(params))
    step, state = jtrain.build_train_step(
        lambda p, b: mod.loss_fn(p, b, dtype=jnp.float32), opt, params,
        j(batches[0]), mesh=_jax_mesh(axes), rules=_jax_rules(_model(name)),
        seq_axis="sp" if "sp" in axes else None, grad_clip=1.0,
        cache=False)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, j(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms, "state": _np(state)}


def _scenario(name, case, mesh, attn, path, steps, **kw):
    return dict({"kind": "step", "name": name, "model": _model(case),
                 "mesh": mesh, "attn": attn, "tree": path(case),
                 "batches": [path("%s_batch%d" % (case, i))
                             for i in range(steps)], "clip": 1.0}, **kw)


def _world(tmp, world, scenarios, refs):
    """One world of ``world`` workers running ``scenarios`` while JAX
    computes ``refs`` (name -> thunk); each rank's outputs by scenario."""
    out = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        workers = pool.submit(tp_check.launch,
                              {"out": tmp, "scenarios": scenarios},
                              world=world, timeout=420,
                              env={"OMP_NUM_THREADS": "1"})
        for name, fn in refs.items():
            out[name] = fn()
        workers.result()
    got = {sc["name"]: [dp_check.load_tree(os.path.join(
        tmp, "%s.rank%d.npz" % (sc["name"], r))) for r in range(world)]
        for sc in scenarios}
    return got, out


def _inputs(tmp, names, batch, steps):
    trees = {}
    for name in names:
        mod = {"bert": jbert, "gpt": jgpt}[_model(name)]
        trees[name] = _np(mod.init(KEY, CONFIGS[name]))
        for i, b in enumerate(_batches(name, steps, batch)):
            trees["%s_batch%d" % (name, i)] = b
    for name, t in trees.items():
        dp_check.save_tree(os.path.join(tmp, name + ".npz"), t)
    return trees, lambda name: os.path.join(tmp, name + ".npz")


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("hybrid4"))
    names = sorted({c for c, _, _ in CASES.values()})
    trees, path = _inputs(tmp, names, 4, 1)
    scenarios = [_scenario(n, c, m, a, path, 1)
                 for n, (c, m, a) in CASES.items()]
    scenarios += [dict(_scenario("fault_" + f, CASES[n][0], CASES[n][1],
                                 CASES[n][2], path, 1), fault=f)
                  for f, n in FAULT_CASE.items()]
    refs = {}
    for c, m in sorted({(c, tuple(sorted(m.items())))
                        for c, m, _ in CASES.values()}):
        refs["%s_%s" % (c, json.dumps(dict(m)))] = (
            lambda c=c, m=m: _jax_steps(c, trees[c],
                                        [trees[c + "_batch0"]], dict(m)))
    got, ref = _world(tmp, 4, scenarios, refs)
    return {"got": got, "ref": ref}


@pytest.fixture(scope="module")
def program1(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("hybrid8"))
    trees, path = _inputs(tmp, ["bert_moe"], 2, 2)
    scenarios = [_scenario("program1", "bert_moe", PROGRAM1, "ring", path,
                           2)]
    refs = {"program1": lambda: _jax_steps(
        "bert_moe", trees["bert_moe"],
        [trees["bert_moe_batch0"], trees["bert_moe_batch1"]], PROGRAM1)}
    return _world(tmp, 8, scenarios, refs)


def _coords(rank, axes):
    out, rest = {}, rank
    for name, n in reversed(list(axes.items())):
        out[name], rest = rest % n, rest // n
    return out


def _state_error(got_state, want_state, axes, rank, model):
    """Largest |got - want| / max(1, |want|) over the leaves, each tile
    against its slice of the whole leaf."""
    want = bridge.flatten(want_state)
    specs = tsharding.shard_tree(want_state, axes,
                                 tp_check.model_rules(model))
    coords = _coords(rank, axes)
    worst = 0.0
    for k, v in bridge.flatten(got_state).items():
        w = np.asarray(tsharding.cut(np.asarray(want[k]), tsharding.tile_of(
            specs[k], axes, coords)))
        assert v.shape == w.shape, k
        worst = max(worst, float(np.max(np.abs(v - w), initial=0.0)
                                 / max(1.0, np.max(np.abs(w), initial=0.0))))
    return worst


def _problems(got, ref, axes, model):
    """The gates a case fails: losses and clip norms within LOSS_RTOL on
    every rank, the state within STATE_TOL, the replicated leaves
    bitwise on every rank, the tiles bitwise on the ranks that share the
    model axes' coordinates (tp, ep, fsdp)."""
    problems = []
    for r, g in enumerate(got):
        for key in ("losses", "grad_norms"):
            vals = np.asarray(g[key]).reshape(-1)
            if len(vals) != len(ref[key]):
                problems.append("%s rank %d: %d values" % (key, r,
                                                           len(vals)))
            for a, b in zip(vals, ref[key]):
                if not abs(float(a) - b) <= LOSS_RTOL * abs(b):
                    problems.append("%s rank %d: %r, want %r"
                                    % (key, r, float(a), b))
        err = _state_error(g["state"], ref["state"], axes, r, model)
        if not err <= STATE_TOL:
            problems.append("state rank %d off by %g" % (r, err))
    if len({str(g["replicated"]) for g in got}) != 1:
        problems.append("replicated leaves differ between ranks")
    holders = {}
    for r, g in enumerate(got):
        c = _coords(r, axes)
        key = tuple(c.get(a, 0) for a in ("tp", "ep", "fsdp"))
        holders.setdefault(key, set()).add(str(g["tiles"]))
    if any(len(v) != 1 for v in holders.values()):
        problems.append("tiles differ on the ranks that hold them")
    return problems


def _ref_of(four, case):
    c, m, _ = CASES[case]
    return four["ref"]["%s_%s" % (c, json.dumps(dict(sorted(m.items()))))]


@pytest.mark.parametrize("case", sorted(CASES))
def test_four_workers_match_jax(four, case):
    c, mesh, _ = CASES[case]
    got = four["got"][case]
    assert _problems(got, _ref_of(four, case), mesh, _model(c)) == []
    split = {str(p) for p in got[0]["split"]}
    if "tp" in mesh:
        assert "params/layers/0/attn/q/kernel" in split
        q = bridge.flatten(got[0]["state"])["params/layers/0/attn/q/kernel"]
        assert q.shape[1] == CONFIGS[c]["heads"] // 2
    if "ep" in mesh:
        wi = bridge.flatten(got[0]["state"])["params/layers/0/moe/wi"]
        assert wi.shape[0] == CONFIGS[c]["moe_experts"] // 2
        # the router stays whole, and no MoE leaf is split over tp
        assert "params/layers/0/moe/router/kernel" not in split


def test_program1_matches_the_reference_dry_run(program1):
    """Dry-run program 1, eight workers against eight JAX devices: two
    steps, each rank's tiles against their slices."""
    got, ref = program1
    assert _problems(got["program1"], ref["program1"], PROGRAM1,
                     "bert") == []
    state = bridge.flatten(got["program1"][0]["state"])
    assert state["params/layers/0/moe/wi"].shape[0] == 2
    assert state["params/layers/0/attn/q/kernel"].shape[1] == 2
    assert state["params/embed/tok/table"].shape[0] == 512
    assert len(ref["program1"]["losses"]) == 2


def test_ulysses_refuses_heads_that_do_not_divide():
    """A tp rank's heads (H / tp) must divide by sp for Ulysses: 1 head a
    rank on tp2 x sp2 is refused, with the tp split named."""
    mesh = make_mesh({"tp": 2, "sp": 2}, world=4)
    q = torch.zeros(1, 1, 16, 8)
    with pytest.raises(ValueError, match="under tp 2"):
        context.ulysses_attention(q, q, q, mesh)


@pytest.mark.parametrize("fault", tp_check.HYBRID_FAULTS)
def test_planted_fault_is_rejected(four, fault):
    case = FAULT_CASE[fault]
    c, mesh, _ = CASES[case]
    got = four["got"]["fault_" + fault]
    assert _problems(got, _ref_of(four, case), mesh, _model(c)) != []
