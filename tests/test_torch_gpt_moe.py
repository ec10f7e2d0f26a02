"""GPT with switch-MoE FFNs in the torch port against the JAX package, on
the CPU.

The tree is JAX-initialised (``gpt.init(PRNGKey(0), TINY_MOE_CONFIG)``:
2 layers, both MoE with 4 experts) and converted by the bridge; batches
are numpy ids from a seed; attention is the einsum path on both sides.
The JAX side runs its dense MoE formulation (its fused one needs a TPU
there); the port runs its dense one and, with ``fused_supports``
patched to admit CPU tensors, its fused one on the kernels' plain
versions. In fp32:

* ``gpt.loss_fn``, dense and ``ce_chunk`` heads, remat on and off: loss
  within 1e-5 relative, every grad leaf within 1e-4 of its largest
  magnitude (or of 1), ``moe_aux`` positive and within 1e-6 of JAX's;
* ``encode`` and ``apply`` return ``(x, aux)`` as the reference's do;
* three ``build_train_step`` calls with adamw, ``grad_clip=1.0``, remat
  and ``ce_chunk``, each from JAX's state: losses within 1e-4 relative,
  state leaves within 1e-4 of their scale;
* ``examples/train_gpt.make_job`` with ``TPUJOB_MOE_EXPERTS`` builds MoE
  FFNs on the even layers;
* a MoE tree with adamw state crosses both checkpoint packages bit for
  bit.
"""

import functools

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge
from paddle_operator_tpu_torch.examples import train_gpt
from paddle_operator_tpu_torch.models import gpt as tgpt
from paddle_operator_tpu_torch.ops import moe as tmoe
from paddle_operator_tpu_torch.ops import optim as topt
from paddle_operator_tpu_torch.parallel import build_train_step
from paddle_operator_tpu_torch.utils import checkpoint as tckpt
from paddle_operator_tpu_torch.utils.checkpoint import load_into

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from paddle_operator_tpu.models import gpt as jgpt  # noqa: E402
from paddle_operator_tpu.ops import optim as jopt  # noqa: E402
from paddle_operator_tpu.parallel import train as jtrain  # noqa: E402

CFG = dict(jgpt.TINY_MOE_CONFIG)
SEQ, BATCH, CHUNK = 64, 2, 48
F32 = torch.float32


@pytest.fixture(scope="module")
def tree():
    return jax.tree_util.tree_map(np.asarray,
                                  jgpt.init(jax.random.PRNGKey(0), CFG))


@pytest.fixture
def port_fused(request, monkeypatch):
    """The port's MoE formulation: "dense", or "fused" on the plain
    kernels (``fused_supports`` admits CPU tensors, the env asks for it)."""
    if request.param == "fused":
        monkeypatch.setenv("TPUJOB_MOE_FUSED", "1")
        monkeypatch.setattr(tmoe, "fused_supports", lambda *a: True)
        calls = []
        real = tmoe.moe_apply_fused
        monkeypatch.setattr(tmoe, "moe_apply_fused",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        return calls
    monkeypatch.setenv("TPUJOB_MOE_FUSED", "0")
    return None


def _ids(seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32)


def _port(tree):
    return bridge.params_from_numpy(tree, device="cpu")


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, rel):
    """Every leaf within ``rel`` of max(1, its largest magnitude)."""
    g, w = bridge.flatten(got), bridge.flatten(want)
    assert sorted(g) == sorted(w)
    for k in w:
        x, y = np.asarray(g[k], np.float64), np.asarray(w[k], np.float64)
        assert x.shape == y.shape, k
        bound = rel * max(1.0, float(np.max(np.abs(y))))
        assert np.max(np.abs(x - y)) <= bound, (k, np.max(np.abs(x - y)))


@functools.lru_cache(maxsize=None)
def _jax_loss(ce_chunk):
    tree = jax.tree_util.tree_map(np.asarray,
                                  jgpt.init(jax.random.PRNGKey(0), CFG))

    def loss(p, b):
        return jgpt.loss_fn(p, b, dtype=jnp.float32, remat=True,
                            attn_impl="einsum", ce_chunk=ce_chunk)

    (l, aux), g = jax.value_and_grad(loss, has_aux=True)(
        _jnp(tree), {"input_ids": jnp.asarray(_ids())})
    return (float(l), float(aux["accuracy"]), float(aux["moe_aux"]),
            jax.tree_util.tree_map(np.asarray, g))


@pytest.mark.parametrize("port_fused", ["dense", "fused"], indirect=True)
@pytest.mark.parametrize("ce_chunk", [0, CHUNK])
@pytest.mark.parametrize("remat", [False, True])
def test_moe_loss_fn_and_grads_match_jax(tree, port_fused, ce_chunk, remat):
    want_l, want_acc, want_aux, want_g = _jax_loss(ce_chunk)
    params = _port(tree)
    leaves = bridge.flatten(params)
    for t in leaves.values():
        t.requires_grad_()
    loss, aux = tgpt.loss_fn(params, {"input_ids": torch.from_numpy(_ids())},
                             dtype=F32, remat=remat, attn_impl="einsum",
                             ce_chunk=ce_chunk)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    if port_fused is not None:      # both MoE layers took the fused path
        assert len(port_fused) == (4 if remat else 2)
    assert abs(loss.item() - want_l) <= 1e-5 * abs(want_l)
    assert float(aux["accuracy"]) == pytest.approx(want_acc, abs=1e-6)
    assert float(aux["moe_aux"]) > 0.0
    assert abs(float(aux["moe_aux"]) - want_aux) <= 1e-6
    _close(bridge.unflatten(bridge.structure(params),
                            {k: g.numpy() for k, g in zip(leaves, grads)}),
           want_g, 1e-4)


def test_encode_and_apply_return_the_aux_loss(tree):
    ids = _ids(1)
    jl, jaux = jgpt.apply(_jnp(tree), jnp.asarray(ids), dtype=jnp.float32,
                          attn_impl="einsum")
    tl, taux = tgpt.apply(_port(tree), torch.from_numpy(ids), dtype=F32,
                          attn_impl="einsum")
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < 1e-4
    assert float(taux) > 0.0 and abs(float(taux) - float(jaux)) <= 1e-6
    hidden, eaux = tgpt.encode(_port(tree), torch.from_numpy(ids), dtype=F32,
                               attn_impl="einsum")
    assert hidden.shape == (BATCH, SEQ, CFG["hidden"])
    assert float(eaux) == float(taux)


def _jax_train(tree, batches):
    opt = jopt.adamw(jopt.cosine_schedule(3e-4, 3, 1), weight_decay=0.1)
    loss = lambda p, b: jgpt.loss_fn(  # noqa: E731
        p, b, dtype=jnp.float32, remat=True, attn_impl="einsum",
        ce_chunk=CHUNK)
    step, state = jtrain.build_train_step(
        loss, opt, _jnp(tree), _jnp(batches[0]), cache=False, grad_clip=1.0)
    host = lambda s: jax.tree_util.tree_map(np.array, s)  # noqa: E731
    states, losses = [host(state)], []
    for b in batches:
        state, m = step(state, _jnp(b))
        losses.append(float(m["loss"]))
        states.append(host(state))
    return losses, states


@pytest.mark.parametrize("port_fused", ["dense", "fused"], indirect=True)
def test_moe_train_steps_match_jax(tree, port_fused):
    batches = [{"input_ids": _ids(seed)} for seed in (10, 11, 12)]
    want_losses, want_states = _jax_train(tree, batches)
    opt = topt.adamw(topt.cosine_schedule(3e-4, 3, 1), weight_decay=0.1)
    loss = lambda p, b: tgpt.loss_fn(  # noqa: E731
        p, b, dtype=F32, remat=True, attn_impl="einsum", ce_chunk=CHUNK)
    step, state = build_train_step(
        loss, opt, _port(tree),
        bridge.params_from_numpy(batches[0], device="cpu"), grad_clip=1.0)
    for b, start, want_l, want in zip(batches, want_states, want_losses,
                                      want_states[1:]):
        load_into(state, start)
        state, m = step(state, bridge.params_from_numpy(b, device="cpu"))
        assert abs(float(m["loss"]) - want_l) <= 1e-4 * abs(want_l)
        assert float(m["moe_aux"]) > 0.0
        _close(bridge.params_to_numpy(state), want, 1e-4)
    assert int(state["opt"]["step"]) == 3


def test_make_job_builds_moe_on_even_layers():
    env = {"TPUJOB_MOE_EXPERTS": "4", "TPUJOB_LAYERS": "4",
           "TPUJOB_HIDDEN": "64", "TPUJOB_HEADS": "2", "TPUJOB_MLP_DIM": "96",
           "TPUJOB_VOCAB": "128", "TPUJOB_SEQ": "32", "TPUJOB_BATCH": "2"}
    job = train_gpt.make_job(env)
    params = job.init_params(torch.Generator().manual_seed(0))
    assert ["moe" in layer for layer in params["layers"]] == [
        True, False, True, False]
    assert ["mlp" in layer for layer in params["layers"]] == [
        False, True, False, True]
    moe = params["layers"][0]["moe"]
    assert moe["wi"].shape == (4, 64, 96) and moe["wo"].shape == (4, 96, 64)
    assert moe["router"]["kernel"].shape == (64, 4)
    batch = job.make_batch(torch.Generator().manual_seed(1), 0)
    loss, aux = job.loss_fn(bridge.tree_map(lambda t: t, params), batch)
    assert np.isfinite(float(loss)) and float(aux["moe_aux"]) > 0.0
    # MoE under a sequence split builds the dp x sp job with the
    # reference's rules (the MoE layers route over the global batch)
    sp = train_gpt.make_job(dict(env, TPUJOB_SP="2"))
    assert sp.mesh_axes == {"dp": -1, "sp": 2} and sp.seq_axis == "sp"
    assert sp.rules == job.rules and (r"moe/w(i|o)$", ("ep", None, None)) \
        in sp.rules
    assert "moe" in sp.init_params(torch.Generator().manual_seed(0))[
        "layers"][0]


def test_moe_state_round_trips_through_both_checkpoint_packages(tmp_path,
                                                                tree):
    from paddle_operator_tpu.utils import checkpoint as jckpt

    params = _port(tree)
    opt = topt.adamw(1e-3)
    state = {"params": params, "opt": opt.init(params)}
    opt.update(bridge.tree_map(torch.ones_like, params), state["opt"],
               params)
    want = bridge.params_to_numpy(state)
    names = bridge.flatten(want)
    for name in ("params/layers/0/moe/wi", "params/layers/1/moe/wo",
                 "params/layers/0/moe/router/kernel",
                 "opt/mu/layers/0/moe/wi", "opt/nu/layers/1/moe/wo"):
        assert name in names
    writer = tckpt.AsyncCheckpointer()
    writer.save(str(tmp_path / "port"), 1, state, meta={"epoch": 0})
    writer.wait()
    got, manifest = jckpt.restore_checkpoint(str(tmp_path / "port"))
    assert manifest["step"] == 1
    assert sorted(bridge.flatten(got)) == sorted(names)
    for k, x in names.items():
        assert np.array_equal(np.asarray(bridge.flatten(got)[k]), x), k

    jckpt.save_checkpoint(str(tmp_path / "jax"), 2, want, meta={"epoch": 0})
    fresh = {"params": _port(tree), "opt": opt.init(_port(tree))}
    restored, manifest = tckpt.restore_latest(str(tmp_path / "jax"))
    assert manifest["step"] == 2
    load_into(fresh, restored)
    for k, x in bridge.flatten(bridge.params_to_numpy(fresh)).items():
        assert np.array_equal(x, names[k]), k
