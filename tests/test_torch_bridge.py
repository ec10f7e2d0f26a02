"""The torch port's parameter bridge and layers against the JAX package.

Inputs are made with numpy from a seed and fed to both sides; layers are
compared in fp32 at atol 1e-5.
"""

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge
from paddle_operator_tpu_torch.models import gpt as tgpt
from paddle_operator_tpu_torch.ops import nn as tnn
from paddle_operator_tpu_torch.serving import engine as tengine

ATOL = 1e-5


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], "%s/%s" % (path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, "%s[%d]" % (path, i))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def jax_tree():
    """A JAX-initialised TINY_CONFIG GPT tree, as numpy."""
    jax = pytest.importorskip("jax")

    from paddle_operator_tpu.models import gpt

    params = gpt.init(jax.random.PRNGKey(0), dict(gpt.TINY_CONFIG))
    return jax.tree_util.tree_map(np.asarray, params)


def test_bridge_round_trip_is_bit_equal(jax_tree):
    back = bridge.params_to_numpy(
        bridge.params_from_numpy(jax_tree, device="cpu"))
    want, got = list(_leaves(jax_tree)), list(_leaves(back))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path


def test_params_from_numpy_without_device_needs_cuda(jax_tree,
                                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.params_from_numpy(jax_tree)
    with pytest.raises(RuntimeError):
        bridge.params_from_numpy(jax_tree, device="cuda")


def test_port_init_has_the_jax_tree_keys_and_shapes(jax_tree):
    ours = tgpt.init(torch.Generator().manual_seed(0), tgpt.TINY_CONFIG)
    want = [(p, a.shape) for p, a in _leaves(jax_tree)]
    got = [(p, tuple(t.shape)) for p, t in _leaves(ours)]
    assert got == want
    assert all(t.dtype == torch.float32 for _, t in _leaves(ours))
    # MoE configs build the reference's tree too (layers[i].moe)
    import jax

    from paddle_operator_tpu.models import gpt

    jax_moe = gpt.init(jax.random.PRNGKey(0), gpt.TINY_MOE_CONFIG)
    ours = tgpt.init(torch.Generator().manual_seed(0), tgpt.TINY_MOE_CONFIG)
    assert [(p, tuple(t.shape)) for p, t in _leaves(ours)] == [
        (p, a.shape) for p, a in _leaves(jax_moe)]


def _layer_case(name):
    """(jax output, port output) for one layer on seeded numpy inputs."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from paddle_operator_tpu.ops import nn as jnn
    from paddle_operator_tpu.serving import engine as jengine

    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 4, 16), dtype=np.float32)   # [B,S,H,D]
    flat = rng.standard_normal((3, 5, 24), dtype=np.float32)
    f32, t32 = jnp.float32, torch.float32
    if name == "layernorm":
        p = {"scale": rng.standard_normal(24, dtype=np.float32),
             "bias": rng.standard_normal(24, dtype=np.float32)}
        return (jnn.layernorm(p, flat * 3 + 1, dtype=f32),
                tnn.layernorm(bridge.params_from_numpy(p, device="cpu"),
                              torch.from_numpy(flat * 3 + 1), dtype=t32))
    if name == "dense":
        p = {"kernel": rng.standard_normal((24, 12), dtype=np.float32),
             "bias": rng.standard_normal(12, dtype=np.float32)}
        return (jnn.dense(p, flat, dtype=f32),
                tnn.dense(bridge.params_from_numpy(p, device="cpu"),
                          torch.from_numpy(flat), dtype=t32))
    if name == "gelu":
        return jnn.gelu(flat * 4), tnn.gelu(torch.from_numpy(flat * 4))
    if name == "rope":
        return jnn.rope(x), tnn.rope(torch.from_numpy(x))
    if name == "rope_positions":
        pos = np.asarray([3, 9, 17, 100, 511], np.int32)
        return (jnn.rope(x, jnp.asarray(pos)),
                tnn.rope(torch.from_numpy(x), torch.from_numpy(pos)))
    if name == "rope_rows":
        pos = rng.integers(0, 1024, size=(2, 5)).astype(np.int32)
        return (jengine._rope_rows(x, jnp.asarray(pos)),
                tengine._rope_rows(torch.from_numpy(x), torch.from_numpy(pos)))
    if name == "mha_causal":
        import jax

        jp = jnn.mha_init(jax.random.PRNGKey(1), 24, 4)
        jp = jax.tree_util.tree_map(np.asarray, jp)
        return (jnn.mha(jp, flat, dtype=f32, causal=True, use_rope=True),
                tnn.mha(bridge.params_from_numpy(jp, device="cpu"),
                        torch.from_numpy(flat), dtype=t32, causal=True,
                        use_rope=True))
    raise ValueError(name)


@pytest.mark.parametrize("name", ["layernorm", "dense", "gelu", "rope",
                                  "rope_positions", "rope_rows",
                                  "mha_causal"])
def test_layer_matches_jax(name):
    want, got = _layer_case(name)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.max(np.abs(got.numpy() - want)) < ATOL


def test_port_gpt_forward_matches_jax(jax_tree):
    import jax
    import jax.numpy as jnp

    from paddle_operator_tpu.models import gpt

    ids = np.random.default_rng(3).integers(0, 1024, size=(2, 12))
    want, _ = gpt.apply(jax.tree_util.tree_map(jnp.asarray, jax_tree),
                        jnp.asarray(ids, jnp.int32), dtype=jnp.float32,
                        attn_impl="einsum")
    got, aux = tgpt.apply(bridge.params_from_numpy(jax_tree, device="cpu"),
                          torch.from_numpy(ids), dtype=torch.float32,
                          attn_impl="einsum")
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < 1e-4
    assert float(aux) == 0.0          # a dense config has no MoE aux loss
