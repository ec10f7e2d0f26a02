"""BERT of the torch port (``models/bert.py``, ``examples/train_bert.py``)
against the JAX package's, on the CPU.

Trees are JAX-initialised (``bert.init(PRNGKey(0), TINY_CONFIG)`` and
``TINY_MOE_CONFIG``: 2 layers, both MoE with 4 experts) and converted by
the bridge; batches are numpy from a seed, with an attention mask that
hides the tail of one sequence and a 15 % loss mask. Both sides run the
einsum attention (a mask takes it) and the dense MoE formulation. In
fp32: ``encode`` and ``mlm_logits`` within 1e-5 of their scale, the loss
within 1e-5 relative and every grad leaf within 1e-4 of its largest
magnitude (or of 1), remat on and off; ``moe_aux`` within 1e-6.
"""

import functools

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge
from paddle_operator_tpu_torch.examples import train_bert
from paddle_operator_tpu_torch.models import bert as tbert

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from paddle_operator_tpu.models import bert as jbert  # noqa: E402

CONFIGS = {"dense": jbert.TINY_CONFIG, "moe": jbert.TINY_MOE_CONFIG}
BATCH, SEQ = 2, 64
F32 = torch.float32


@functools.lru_cache(maxsize=None)
def _tree(name):
    return jax.tree_util.tree_map(
        np.asarray, jbert.init(jax.random.PRNGKey(0), CONFIGS[name]))


def _batch(seed=0, vocab=1024):
    rng = np.random.default_rng(seed)
    attention = np.ones((BATCH, SEQ), np.int32)
    attention[1, 40:] = 0
    return {"input_ids": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
            "labels": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
            "type_ids": rng.integers(0, 2, (BATCH, SEQ)).astype(np.int32),
            "loss_mask": (rng.random((BATCH, SEQ)) < 0.15).astype(np.float32),
            "attention_mask": attention}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port(tree):
    return bridge.params_from_numpy(tree, device="cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, rel):
    g, w = bridge.flatten(got), bridge.flatten(want)
    assert sorted(g) == sorted(w)
    for k in w:
        x, y = np.asarray(g[k], np.float64), np.asarray(w[k], np.float64)
        assert x.shape == y.shape, k
        bound = rel * max(1.0, float(np.max(np.abs(y))))
        assert np.max(np.abs(x - y)) <= bound, (k, np.max(np.abs(x - y)))


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_encode_and_mlm_logits_match_jax(name):
    tree, batch = _tree(name), _batch()
    jb = _jnp(batch)
    jh, jaux = jbert.encode(_jnp(tree), jb["input_ids"], jb["type_ids"],
                            jb["attention_mask"], dtype=jnp.float32)
    jl = jbert.mlm_logits(_jnp(tree), jh, dtype=jnp.float32)
    tb = _torch_batch(batch)
    th, taux = tbert.encode(_port(tree), tb["input_ids"], tb["type_ids"],
                            tb["attention_mask"], dtype=F32)
    tl = tbert.mlm_logits(_port(tree), th, dtype=F32)
    assert th.dtype == F32 and tl.dtype == F32
    _close({"h": th.numpy(), "logits": tl.numpy()},
           {"h": np.asarray(jh), "logits": np.asarray(jl)}, 1e-5)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    assert (float(taux) > 0.0) == (name == "moe")


@functools.lru_cache(maxsize=None)
def _jax_loss(name):
    def loss(p, b):
        return jbert.loss_fn(p, b, dtype=jnp.float32, remat=True)

    (l, aux), g = jax.value_and_grad(loss, has_aux=True)(
        _jnp(_tree(name)), _jnp(_batch()))
    return (float(l), float(aux["accuracy"]), float(aux["moe_aux"]),
            jax.tree_util.tree_map(np.asarray, g))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_loss_fn_and_grads_match_jax(name, remat):
    want_l, want_acc, want_aux, want_g = _jax_loss(name)
    params = _port(_tree(name))
    leaves = bridge.flatten(params)
    for t in leaves.values():
        t.requires_grad_()
    loss, aux = tbert.loss_fn(params, _torch_batch(_batch()), dtype=F32,
                              remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    assert abs(loss.item() - want_l) <= 1e-5 * abs(want_l)
    assert float(aux["accuracy"]) == pytest.approx(want_acc, abs=1e-6)
    assert abs(float(aux["moe_aux"]) - want_aux) <= 1e-6
    # the pooler is not on the MLM loss: JAX gives it zeros, autograd None
    got = {k: np.zeros(tuple(leaves[k].shape), np.float32) if g is None
           else g.numpy() for k, g in zip(leaves, grads)}
    assert {k for k, g in zip(leaves, grads) if g is None} == {
        "pooler/bias", "pooler/kernel"}
    _close(bridge.unflatten(bridge.structure(params), got), want_g, 1e-4)


def test_loss_fn_bf16_loose():
    want_l, _, _, _ = _jax_loss("moe")
    loss, _ = tbert.loss_fn(_port(_tree("moe")), _torch_batch(_batch()),
                            remat=True)
    assert abs(float(loss) - want_l) <= 2e-2 * abs(want_l)


def test_init_matches_the_jax_tree_structure():
    for name, cfg in CONFIGS.items():
        got = tbert.init(torch.Generator().manual_seed(0), cfg)
        want = _tree(name)
        g, w = bridge.flatten(got), bridge.flatten(want)
        assert sorted(g) == sorted(w), name
        for k in w:
            assert tuple(g[k].shape) == w[k].shape and g[k].dtype == F32, k


def test_synthetic_batch_shapes_types_and_mask_rate():
    gen = torch.Generator().manual_seed(0)
    b = tbert.synthetic_batch(gen, 8, 128, vocab_size=1000)
    assert set(b) == {"input_ids", "labels", "loss_mask", "attention_mask"}
    for k in ("input_ids", "labels"):
        assert b[k].shape == (8, 128) and b[k].dtype == torch.int64
        assert 0 <= int(b[k].min()) and int(b[k].max()) < 1000
    assert b["loss_mask"].dtype == F32
    assert set(b["loss_mask"].unique().tolist()) <= {0.0, 1.0}
    assert abs(float(b["loss_mask"].mean()) - 0.15) < 0.03
    assert b["attention_mask"].dtype == torch.int32
    assert bool((b["attention_mask"] == 1).all())
    again = tbert.synthetic_batch(torch.Generator().manual_seed(0), 8, 128,
                                  vocab_size=1000)
    assert all(torch.equal(b[k], again[k]) for k in b)


def test_make_job_knobs():
    job = train_bert.make_job({})
    assert job.total_steps == 100 and job.grad_clip == 1.0
    assert job.steps_per_call == 1 and job.checkpoint_dir == ""
    job = train_bert.make_job({"TPUJOB_BATCH": "3", "TPUJOB_SEQ": "16",
                               "TPUJOB_STEPS": "20",
                               "TPUJOB_STEPS_PER_CALL": "2",
                               "TPUJOB_CHECKPOINT_DIR": "/ckpt"})
    assert job.total_steps == 20 and job.steps_per_call == 2
    assert job.checkpoint_dir == "/ckpt"
    batch = job.make_batch(torch.Generator().manual_seed(0), 0)
    assert batch["input_ids"].shape == (3, 16)
    assert int(batch["input_ids"].max()) < tbert.BASE_CONFIG["vocab_size"]
    # adamw on cosine(1e-4, 20, 2), weight decay 0.01: the first step
    # (lr 1e-4 at half its warmup) moves a leaf of ones by lr * (1 + 0.01)
    p = {"w": torch.ones(4)}
    state = job.optimizer.init(p)
    job.optimizer.update({"w": torch.full((4,), 0.5)}, state, p)
    assert torch.allclose(p["w"], torch.full((4,), 1 - 5e-5 * 1.01),
                          rtol=0, atol=1e-7)
