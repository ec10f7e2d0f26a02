"""GPT training of the torch port against the JAX package, on the CPU.

The tree is JAX-initialised (``gpt.init(PRNGKey(0), TINY_CONFIG)`` with
2 heads, so that head_dim is 64 and the flash path applies) and converted
by the bridge; batches are numpy from a seed. The JAX side runs its
Pallas flash kernels in interpret mode (``attn_impl="flash"`` on the CPU
backend); the port runs their plain versions. Everything is compared in
fp32 unless stated:

* ``nn.mha`` with ``impl="flash"`` against JAX's and against the port's
  einsum path, atol 2e-4 (``tests/test_pallas_attention.py``); the mask
  and callable dispatch;
* ``chunked_lm_xent``: loss and grads within 1e-5 of their scale;
* ``gpt.loss_fn`` at seq 256, batch 2: dense and ``ce_chunk`` paths, remat
  on and off: loss within 1e-5 relative, every grad leaf within 1e-4 of
  its largest magnitude (or of 1, if larger); one loose bf16 check of the
  loss within 2e-2 relative;
* ``adamw`` against JAX's over three steps, with and without a
  ``wd_mask``: rtol 5e-6 / atol 1e-6 (``tests/test_fused_ops.py``);
* three ``build_train_step`` calls with adamw, ``grad_clip=1.0``, remat
  and ``ce_chunk``, each started from JAX's state (as
  ``tests/test_torch_train.py`` does): losses within 1e-4 relative, state
  leaves within 1e-4 of their scale;
* an adamw state written by the port's checkpoint writer reads back in
  the JAX package bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge
from paddle_operator_tpu_torch.models import gpt as tgpt
from paddle_operator_tpu_torch.ops import nn as tnn
from paddle_operator_tpu_torch.ops import optim as topt
from paddle_operator_tpu_torch.parallel import build_train_step
from paddle_operator_tpu_torch.utils import checkpoint as tckpt
from paddle_operator_tpu_torch.utils.checkpoint import load_into

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from paddle_operator_tpu.models import gpt as jgpt  # noqa: E402
from paddle_operator_tpu.ops import nn as jnn  # noqa: E402
from paddle_operator_tpu.ops import optim as jopt  # noqa: E402
from paddle_operator_tpu.parallel import train as jtrain  # noqa: E402

CFG = dict(jgpt.TINY_CONFIG, heads=2)    # head_dim 64: flash applies
SEQ, BATCH, CHUNK = 256, 2, 128
F32 = torch.float32


@pytest.fixture(scope="module")
def tree():
    return jax.tree_util.tree_map(np.asarray,
                                  jgpt.init(jax.random.PRNGKey(0), CFG))


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


# ---------------------------------------------------------------------------
# nn.mha dispatch
# ---------------------------------------------------------------------------

def _mha_case(seed=1):
    jp = jax.tree_util.tree_map(np.asarray,
                                jnn.mha_init(jax.random.PRNGKey(seed), 128, 2))
    x = np.random.default_rng(seed).standard_normal((2, 256, 128),
                                                    dtype=np.float32)
    return jp, x


@pytest.mark.parametrize("causal", [False, True])
def test_mha_flash_matches_jax_and_einsum(causal):
    jp, x = _mha_case()
    kw = dict(causal=causal, use_rope=causal)
    want = np.asarray(jnn.mha(_jnp(jp), jnp.asarray(x), dtype=jnp.float32,
                              impl="flash", **kw))
    tp, tx = _port(jp), torch.from_numpy(x)
    got = tnn.mha(tp, tx, dtype=F32, impl="flash", **kw).numpy()
    einsum = tnn.mha(tp, tx, dtype=F32, impl="einsum", **kw).numpy()
    assert np.max(np.abs(got - want)) < 2e-4
    assert np.max(np.abs(got - einsum)) < 2e-4
    # "auto" takes flash only for CUDA tensors: the einsum path here
    auto = tnn.mha(tp, tx, dtype=F32, impl="auto", **kw).numpy()
    assert np.array_equal(auto, einsum)


def test_mha_mask_and_callable_dispatch():
    jp, x = _mha_case(seed=2)
    keep = np.random.default_rng(3).random((2, 1, 1, 256)) > 0.2
    want = np.asarray(jnn.mha(_jnp(jp), jnp.asarray(x), mask=jnp.asarray(keep),
                              dtype=jnp.float32, impl="flash", causal=True))
    tp, tx = _port(jp), torch.from_numpy(x)
    got = tnn.mha(tp, tx, mask=torch.from_numpy(keep), dtype=F32,
                  impl="flash", causal=True).numpy()
    assert np.max(np.abs(got - want)) < 1e-5   # a mask takes the einsum path

    from paddle_operator_tpu.ops.attention_pallas import \
        _reference_attention as jref
    from paddle_operator_tpu_torch.ops.attention import \
        _reference_attention as tref

    want = np.asarray(jnn.mha(_jnp(jp), jnp.asarray(x), dtype=jnp.float32,
                              impl=functools.partial(jref, scale=0.125,
                                                     causal=True)))
    got = tnn.mha(tp, tx, dtype=F32, impl=functools.partial(
        tref, scale=0.125, causal=True)).numpy()
    assert np.max(np.abs(got - want)) < 1e-5
    with pytest.raises(ValueError):
        tnn.mha(tp, tx, dtype=F32, causal=True, impl=functools.partial(
            tref, scale=0.125))


# ---------------------------------------------------------------------------
# chunked LM-head cross-entropy
# ---------------------------------------------------------------------------

def test_chunked_lm_xent_matches_jax():
    rng = np.random.default_rng(4)
    d, vocab = 64, 1000          # 300 tokens in chunks of 128: padded
    head = {"kernel": rng.standard_normal((d, vocab), np.float32) * 0.05,
            "bias": rng.standard_normal((vocab,), np.float32) * 0.1}
    hidden = rng.standard_normal((2, 150, d), np.float32)
    labels = rng.integers(0, vocab, (2, 150)).astype(np.int32)
    mask = (rng.random((2, 150)) > 0.1).astype(np.float32)

    def jloss(h, hidden):
        return jnn.chunked_lm_xent(h, hidden, jnp.asarray(labels),
                                   mask=jnp.asarray(mask), chunk=128,
                                   dtype=jnp.float32)

    (want_l, want_a), want_g = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(_jnp(head), jnp.asarray(hidden))
    th = {k: torch.from_numpy(v).requires_grad_() for k, v in head.items()}
    thid = torch.from_numpy(hidden).requires_grad_()
    loss, acc = tnn.chunked_lm_xent(th, thid, torch.from_numpy(labels),
                                    mask=torch.from_numpy(mask), chunk=128,
                                    dtype=F32)
    grads = torch.autograd.grad(loss, [th["kernel"], th["bias"], thid])
    assert abs(loss.item() - float(want_l)) <= 1e-5 * abs(float(want_l))
    assert acc.item() == pytest.approx(float(want_a), abs=1e-7)
    _close({"kernel": grads[0].numpy(), "bias": grads[1].numpy(),
            "hidden": grads[2].numpy()},
           {"kernel": np.asarray(want_g[0]["kernel"]),
            "bias": np.asarray(want_g[0]["bias"]),
            "hidden": np.asarray(want_g[1])}, 1e-5)


# ---------------------------------------------------------------------------
# gpt.loss_fn
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_loss(ce_chunk, dtype_name="float32"):
    tree = jax.tree_util.tree_map(np.asarray,
                                  jgpt.init(jax.random.PRNGKey(0), CFG))
    dtype = getattr(jnp, dtype_name)

    def loss(p, b):
        return jgpt.loss_fn(p, b, dtype=dtype, remat=True, attn_impl="flash",
                            ce_chunk=ce_chunk)

    (l, aux), g = jax.value_and_grad(loss, has_aux=True)(
        _jnp(tree), {"input_ids": jnp.asarray(_ids())})
    return float(l), float(aux["accuracy"]), jax.tree_util.tree_map(
        np.asarray, g)


@pytest.mark.parametrize("ce_chunk", [0, CHUNK])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_and_grads_match_jax(tree, ce_chunk, remat):
    """JAX's remat only recomputes, so one JAX result per head path is the
    reference for both of the port's remat settings."""
    want_l, want_acc, want_g = _jax_loss(ce_chunk)
    params = _port(tree)
    leaves = bridge.flatten(params)
    for t in leaves.values():
        t.requires_grad_()
    loss, aux = tgpt.loss_fn(params, {"input_ids": torch.from_numpy(_ids())},
                             dtype=F32, remat=remat, attn_impl="flash",
                             ce_chunk=ce_chunk)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert abs(loss.item() - want_l) <= 1e-5 * abs(want_l)
    assert float(aux["accuracy"]) == pytest.approx(want_acc, abs=1e-6)
    assert float(aux["moe_aux"]) == 0.0
    _close(bridge.unflatten(bridge.structure(params),
                            {k: g.numpy() for k, g in zip(leaves, grads)}),
           want_g, 1e-4)


def test_loss_fn_bf16_loose(tree):
    """bf16 compute rounds at other places in the two frameworks: the
    loss agrees within 2e-2 relative."""
    want_l, _, _ = _jax_loss(CHUNK, "bfloat16")
    loss, _ = tgpt.loss_fn(_port(tree),
                           {"input_ids": torch.from_numpy(_ids())},
                           remat=True, attn_impl="flash", ce_chunk=CHUNK)
    assert abs(float(loss) - want_l) <= 2e-2 * abs(want_l)


def test_synthetic_batch_and_loss_mask(tree):
    gen = torch.Generator().manual_seed(0)
    batch = tgpt.synthetic_batch(gen, 2, 256, CFG["vocab_size"])
    assert batch["input_ids"].shape == (2, 256)
    assert int(batch["input_ids"].max()) < CFG["vocab_size"]
    ids = _ids()
    mask = np.ones_like(ids, np.float32)
    mask[:, 200:] = 0
    jl, _ = jgpt.loss_fn(_jnp(tree), {"input_ids": jnp.asarray(ids),
                                      "loss_mask": jnp.asarray(mask)},
                         dtype=jnp.float32, attn_impl="einsum")
    tl, _ = tgpt.loss_fn(_port(tree), {"input_ids": torch.from_numpy(ids),
                                       "loss_mask": torch.from_numpy(mask)},
                         dtype=F32, attn_impl="einsum")
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))


# ---------------------------------------------------------------------------
# adamw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_adamw_matches_jax(tree, masked):
    rng = np.random.default_rng(5)
    grads = [bridge.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.1,
        tree) for _ in range(3)]
    sched = (jopt.cosine_schedule(3e-3, 3, 1), topt.cosine_schedule(3e-3, 3, 1))
    jo = jopt.adamw(sched[0], weight_decay=0.1,
                    wd_mask=jopt.make_wd_mask(tree) if masked else None)
    to = topt.adamw(sched[1], weight_decay=0.1,
                    wd_mask=topt.make_wd_mask(tree) if masked else None)
    jp, js = _jnp(tree), jo.init(_jnp(tree))
    tp = _port(tree)
    ts = to.init(tp)
    for g in grads:
        jp, js = jo.update(_jnp(g), js, jp)
        tp, ts = to.update(bridge.params_from_numpy(g, device="cpu"), ts, tp)
    want = jax.tree_util.tree_map(np.asarray, {"params": jp, "opt": js})
    got = bridge.params_to_numpy({"params": tp, "opt": ts})
    assert int(got["opt"]["step"]) == 3 and got["opt"]["step"].dtype == np.int32
    w, g = bridge.flatten(want), bridge.flatten(got)
    assert sorted(w) == sorted(g)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=5e-6, atol=1e-6,
                                   err_msg=k)


def test_adamw_state_round_trips_through_the_checkpoint(tmp_path, tree):
    from paddle_operator_tpu.utils import checkpoint as jckpt

    params = _port(tree)
    opt = topt.adamw(1e-3)
    state = {"params": params, "opt": opt.init(params)}
    opt.update(bridge.tree_map(torch.ones_like, params), state["opt"],
               params)
    want = bridge.params_to_numpy(state)
    writer = tckpt.AsyncCheckpointer()
    writer.save(str(tmp_path), 1, state, meta={"epoch": 0})
    writer.wait()
    got, manifest = jckpt.restore_checkpoint(str(tmp_path))
    assert manifest["step"] == 1
    assert sorted(bridge.flatten(got)) == sorted(bridge.flatten(want))
    assert "opt/mu/embed/tok/table" in bridge.flatten(got)
    for k, x in bridge.flatten(want).items():
        assert np.array_equal(np.asarray(bridge.flatten(got)[k]), x), k
    fresh = {"params": _port(tree), "opt": opt.init(_port(tree))}
    restored, _ = tckpt.restore_latest(str(tmp_path))
    load_into(fresh, restored)
    for k, x in bridge.flatten(bridge.params_to_numpy(fresh)).items():
        assert np.array_equal(x, bridge.flatten(want)[k]), k


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _jax_train(tree, batches):
    opt = jopt.adamw(jopt.cosine_schedule(3e-4, 3, 1), weight_decay=0.1)
    loss = lambda p, b: jgpt.loss_fn(  # noqa: E731
        p, b, dtype=jnp.float32, remat=True, attn_impl="flash",
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


def test_train_step_matches_jax(tree):
    batches = [{"input_ids": _ids(seed)} for seed in (10, 11, 12)]
    want_losses, want_states = _jax_train(tree, batches)
    opt = topt.adamw(topt.cosine_schedule(3e-4, 3, 1), weight_decay=0.1)
    loss = lambda p, b: tgpt.loss_fn(  # noqa: E731
        p, b, dtype=F32, remat=True, attn_impl="flash", ce_chunk=CHUNK)
    step, state = build_train_step(
        loss, opt, _port(tree),
        bridge.params_from_numpy(batches[0], device="cpu"), grad_clip=1.0)
    for b, start, want_l, want in zip(batches, want_states, want_losses,
                                      want_states[1:]):
        load_into(state, start)
        state, m = step(state, bridge.params_from_numpy(b, device="cpu"))
        assert abs(float(m["loss"]) - want_l) <= 1e-4 * abs(want_l)
        assert float(m["grad_norm"]) > 1.0   # the clip is active
        _close(bridge.params_to_numpy(state), want, 1e-4)
    assert int(state["opt"]["step"]) == 3
