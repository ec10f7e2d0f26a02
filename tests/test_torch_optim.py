"""The torch port's SGD family against the JAX package, mirroring the JAX
package's own fused-optimizer tests (``tests/test_fused_ops.py``).

On the CPU the port's ``fused_sgd`` runs the plain version of its CUDA
kernel. Tolerances are the reference's: rtol 5e-6 / atol 1e-6 between
the two packages (XLA may contract ``a*b + c`` into an FMA, torch rounds
twice), and bitwise where no rounding is involved (first-step momentum
from zero) or where both sides run the same torch ops (port ``sgd``
against port ``fused_sgd``). The CUDA kernel is held against its plain
version in ``tests/test_torch_fused_sgd.py``.
"""

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge
from paddle_operator_tpu_torch.ops import optim as topt

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from paddle_operator_tpu.ops import optim as jopt  # noqa: E402

RTOL, ATOL = 5e-6, 1e-6


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    p = {"w": rng.standard_normal((300, 7), dtype=np.float32),
         "b": np.ones((13,), np.float32),
         "scalar": np.asarray(2.0, np.float32)}
    g = {k: (v * 0.01 + 0.001).astype(np.float32) for k, v in p.items()}
    return p, g


def _t(tree):
    return bridge.params_from_numpy(tree, device="cpu")


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(want, got, rtol=RTOL, atol=ATOL):
    w, g = bridge.flatten(want), bridge.flatten(got)
    assert list(w) == list(g)
    for k in w:
        np.testing.assert_allclose(
            np.asarray(g[k].numpy() if isinstance(g[k], torch.Tensor)
                       else g[k], np.float64),
            np.asarray(w[k], np.float64), rtol=rtol, atol=atol, err_msg=k)


def _equal(want, got):
    w = bridge.flatten(bridge.tree_map(np.asarray, want))
    g = bridge.flatten(bridge.params_to_numpy(got))
    assert list(w) == list(g)
    for k in w:
        assert np.array_equal(w[k], g[k]), k


def _run(opt, p, g, steps, torch_side):
    """``steps`` updates with the same grads; returns (params, state)."""
    if torch_side:
        params, grads = _t(p), _t(g)
        state = opt.init(params)
        for _ in range(steps):
            params, state = opt.update(grads, state, params)
        return params, state
    params, grads = _j(p), _j(g)
    state = opt.init(params)
    for _ in range(steps):
        params, state = opt.update(grads, state, params)
    return params, state


@pytest.mark.parametrize("port", ["sgd", "fused_sgd"])
def test_first_step_momentum_bit_identical(port):
    p, g = _setup()
    ours = getattr(topt, port)(0.1, momentum=0.9)
    for ref in (jopt.sgd(0.1, momentum=0.9),
                jopt.fused_sgd(0.1, momentum=0.9, interpret=True)):
        p1, s1 = _run(ref, p, g, 1, False)
        p2, s2 = _run(ours, p, g, 1, True)
        _close(p1, p2)
        _equal(s1["momentum"], s2["momentum"])
        assert int(s1["step"]) == int(s2["step"]) == 1


@pytest.mark.parametrize("kw", [
    {}, {"nesterov": True}, {"weight_decay": 1e-2},
    {"weight_decay": 1e-2, "nesterov": True}])
def test_multi_step_matches_jax_within_ulps(kw):
    p, g = _setup(1)
    pr, sr = _run(jopt.sgd(0.1, momentum=0.9, **kw), p, g, 5, False)
    pf, sf = _run(jopt.fused_sgd(0.1, momentum=0.9, interpret=True, **kw),
                  p, g, 5, False)
    for port in (topt.sgd, topt.fused_sgd):
        pt, st = _run(port(0.1, momentum=0.9, **kw), p, g, 5, True)
        for want_p, want_s in ((pr, sr), (pf, sf)):
            _close(want_p, pt)
            _close(want_s["momentum"], st["momentum"])
        assert int(st["step"]) == 5 and st["step"].dtype == torch.int32


def test_port_sgd_and_fused_plain_are_bitwise_equal():
    """Both run the same torch ops on the CPU, in the same order."""
    p, g = _setup(2)
    sched = topt.cosine_schedule(0.1, 100, 10)
    kw = dict(momentum=0.9, weight_decay=1e-3, nesterov=True)
    pa, sa = _run(topt.sgd(sched, **kw), p, g, 5, True)
    pb, sb = _run(topt.fused_sgd(sched, **kw), p, g, 5, True)
    _equal(bridge.params_to_numpy(pa), pb)
    _equal(bridge.params_to_numpy(sa["momentum"]), sb["momentum"])


def test_weight_decay_and_mask():
    """Decay applies only where the mask says."""
    p, g = _setup()
    mask = {"w": True, "b": False, "scalar": False}
    ref = jopt.sgd(0.1, momentum=0.9, weight_decay=1e-2, wd_mask=mask)
    p1, _ = _run(ref, p, g, 1, False)
    ours = topt.fused_sgd(0.1, momentum=0.9, weight_decay=1e-2, wd_mask=mask)
    p2, _ = _run(ours, p, g, 1, True)
    _close(p1, p2)
    nod, _ = _run(topt.fused_sgd(0.1, momentum=0.9), p, g, 1, True)
    assert (p2["w"] != nod["w"]).any()
    assert torch.equal(p2["b"], nod["b"])


def test_make_wd_mask_matches_jax():
    from paddle_operator_tpu.models import resnet as jres

    tree = jax.eval_shape(lambda: jres.init(jax.random.PRNGKey(0), 18, 10))
    want = bridge.flatten(jopt.make_wd_mask(tree))
    got = bridge.flatten(topt.make_wd_mask(tree))
    assert got == {k: bool(v) for k, v in want.items()}
    assert got["stem/conv/kernel"] and not got["stem/bn/mean"]


def test_lr_schedule_is_honored():
    p, g = _setup()
    want, _ = _run(jopt.sgd(jopt.cosine_schedule(0.1, 100, 10),
                            momentum=0.9), p, g, 3, False)
    got, _ = _run(topt.fused_sgd(topt.cosine_schedule(0.1, 100, 10),
                                 momentum=0.9), p, g, 3, True)
    _close(want, got)


@pytest.mark.parametrize("warmup", [0, 1, 10])
def test_cosine_schedule_matches_jax(warmup):
    jsched = jopt.cosine_schedule(0.4, 30, warmup)
    tsched = topt.cosine_schedule(0.4, 30, warmup)
    for step in (0, 1, 2, 5, 15, 29, 30, 40):
        want = float(jsched(jnp.asarray(step, jnp.int32)))
        got = tsched(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-7)


def test_state_layout_crosses_to_the_jax_optimizer():
    """Checkpoint interchange: the port's state continues in JAX's sgd."""
    p, g = _setup()
    ours = topt.fused_sgd(0.1, momentum=0.9)
    pt, st = _run(ours, p, g, 1, True)
    assert set(st) == {"step", "momentum"}
    assert st["step"].shape == () and st["step"].dtype == torch.int32
    host = bridge.params_to_numpy(st)
    assert host["step"].dtype == np.int32
    ref = jopt.sgd(0.1, momentum=0.9)
    p2, s2 = ref.update(_j(g), _j(host), _j(bridge.params_to_numpy(pt)))
    assert int(s2["step"]) == 2
    p3, s3 = ours.update(_t(g), st, pt)
    _close(jax.tree_util.tree_map(np.asarray, p2), p3)
    _close(jax.tree_util.tree_map(np.asarray, s2["momentum"]),
           s3["momentum"])


def test_mixed_dtype_tree_takes_sgd():
    """A tree with a bf16 leaf cannot take the kernel: fused_sgd gives
    sgd's result (leaf dtypes kept) and launches nothing."""
    p = {"w": torch.ones((8, 8)), "h": torch.ones((4,), dtype=torch.bfloat16)}
    g = {k: v * 0.1 for k, v in p.items()}
    a = {k: v.clone() for k, v in p.items()}
    b = {k: v.clone() for k, v in p.items()}
    ref = topt.sgd(0.1, momentum=0.9, weight_decay=1e-2)
    fus = topt.fused_sgd(0.1, momentum=0.9, weight_decay=1e-2)
    a, _ = ref.update(g, ref.init(a), a)
    b, _ = fus.update(g, fus.init(b), b)
    assert b["h"].dtype == torch.bfloat16
    assert torch.equal(a["w"], b["w"]) and torch.equal(a["h"], b["h"])
    jp = {"w": jnp.ones((8, 8), jnp.float32),
          "h": jnp.ones((4,), jnp.bfloat16)}
    jg = jax.tree_util.tree_map(lambda x: x * 0.1, jp)
    jref = jopt.sgd(0.1, momentum=0.9, weight_decay=1e-2)
    want, _ = jref.update(jg, jref.init(jp), jp)
    assert np.array_equal(np.asarray(want["h"].astype(jnp.float32)),
                          b["h"].float().numpy())
    np.testing.assert_allclose(b["w"].numpy(), np.asarray(want["w"]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("port", ["sgd", "fused_sgd"])
def test_none_grads_count_as_zeros(port):
    """BN running stats get no grad from autograd; the reference gives
    them zeros, and with decay and no mask their momentum still moves."""
    p, g = _setup()
    jg = dict(g, b=np.zeros_like(g["b"]))
    want_p, want_s = _run(jopt.sgd(0.1, momentum=0.9, weight_decay=1e-2),
                          p, jg, 2, False)
    opt = getattr(topt, port)(0.1, momentum=0.9, weight_decay=1e-2)
    params, grads = _t(p), dict(_t(g), b=None)
    state = opt.init(params)
    for _ in range(2):
        params, state = opt.update(grads, state, params)
    _close(want_p, params)
    _close(want_s["momentum"], state["momentum"])
    assert state["momentum"]["b"].abs().max() > 0


def test_global_norm_and_clip_match_jax():
    p, g = _setup(3)
    np.testing.assert_allclose(float(topt.global_norm(_t(g))),
                               float(jopt.global_norm(_j(g))), rtol=1e-6)
    for max_norm in (0.01, 100.0):
        want, wn = jopt.clip_by_global_norm(_j(g), max_norm)
        got, gn = topt.clip_by_global_norm(_t(g), max_norm)
        np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
        _close(jax.tree_util.tree_map(np.asarray, want), got)


def test_update_is_in_place_and_cpu_counts_no_launch():
    p, g = _setup()
    params = _t(p)
    w = params["w"]
    opt = topt.fused_sgd(0.1)
    state = opt.init(params)
    mom = state["momentum"]["w"]
    before = topt.multi_tensor_sgd.launches
    out, state = opt.update(_t(g), state, params)
    assert out is params and out["w"] is w
    assert state["momentum"]["w"] is mom
    assert topt.multi_tensor_sgd.launches == before
