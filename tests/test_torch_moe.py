"""The switch-MoE layer of the torch port (``ops/moe.py``) against the JAX
package's, on the CPU, and kernels B4a/B4b (``csrc/moe.cu``) against
their plain versions on the card.

The MoE parameters are JAX-initialised (``moe.moe_init``) and converted by
the bridge; activations are numpy normals from a seed. The JAX side runs
its dense formulation and its fused one with the Pallas kernels in
interpret mode; the port runs its dense formulation and its fused one on
the kernels' plain versions (CPU tensors). In fp32:

* routing (choice, position, capacity) equal; gate and aux loss within
  1e-6; the fixture's top-2 probability margin is asserted, so that the
  test checks arithmetic and not a near tie;
* the dense layer within 1e-5 of JAX's; the fused one within 1e-5 of
  JAX's fused one and at JAX's class of its own dense path (rtol 5e-6,
  atol 1e-6); the dispatched rows and the combined rows bitwise equal to
  JAX's Pallas kernels' (each element one copy or one product);
* gradients of both formulations against both of JAX's at
  ``tests/test_fused_ops.py``'s class: wi/wo 1e-4, router and input 1e-3;
* 24 tokens and ``capacity_factor=0.5``: some tokens are dropped, and
  their output rows and input-gradient rows are exact zeros;
* bf16 within 0.05, as ``tests/test_fused_ops.py`` bounds it.

Combine's backward dispatches the cotangent with the gate as the
dispatch's per-token scale: the scaled plain dispatch is held bitwise to
the dispatch of the fp32 product and to JAX's ``_dispatch_call`` on
``dout32 * gate`` (the reference's ``_fused_combine_bwd``).

The ``cuda``-marked tests skip without a card; on one
(``python -m pytest tests/test_torch_moe.py -m cuda``) they hold the
kernels against the plain versions bitwise over every type pair they
take, with and without the gate or scale, on the 16-byte path (D = 768,
and D = 200: 25 chunks, fewer than a warp's lanes) and the scalar path
(D = 203, and a misaligned view), at T = 0 and 1, with every token
dropped, into outputs that were NaN before the call, and the autograd
Functions against autograd through the plain versions.
"""

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge
from paddle_operator_tpu_torch.ops import moe as tmoe

F32, BF16 = torch.float32, torch.bfloat16


def _jax():
    """(jax, jax.numpy, the JAX package's moe); the tests that need them
    skip where jax is missing (the GPU machine runs only the ``cuda``
    tests of this file)."""
    jax = pytest.importorskip("jax")
    from paddle_operator_tpu.ops import moe as jmoe

    return jax, jax.numpy, jmoe


def _setup(dim=128, mlp=256, experts=4, b=2, s=64, seed=0):
    """(numpy JAX-initialised params, numpy x [b, s, dim])."""
    jax, _, jmoe = _jax()
    params = jax.tree_util.tree_map(
        np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed), dim, mlp,
                                  experts))
    x = np.random.default_rng(seed + 1).standard_normal(
        (b, s, dim), dtype=np.float32)
    return params, x


def _jnp(tree):
    jax, jnp, _ = _jax()
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port(tree):
    return bridge.params_from_numpy(tree, device="cpu")


def _top2_margin(params, x):
    logits = x.astype(np.float64) @ params["router"]["kernel"]
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top = np.sort(p, -1)
    return float(np.min(top[..., -1] - top[..., -2]))


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# routing and the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,factor", [(2, 64, 1.25), (1, 24, 0.5)])
def test_route_matches_jax(b, s, factor):
    _, jnp, jmoe = _jax()
    params, x = _setup(b=b, s=s)
    assert _top2_margin(params, x) > 1e-5
    jg, jc, jp, jcap, jaux = jmoe._route(_jnp(params), jnp.asarray(x), factor)
    tg, tc, tp, tcap, taux = tmoe._route(_port(params), torch.from_numpy(x),
                                         factor)
    assert tcap == jcap
    assert tc.dtype == tp.dtype == torch.int64
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    _close(tg.numpy(), np.asarray(jg), 0, 1e-6)
    _close(float(taux["moe_aux_loss"]), float(jaux["moe_aux_loss"]), 0, 1e-6)


def test_dense_moe_apply_matches_jax():
    _, jnp, jmoe = _jax()
    params, x = _setup()
    want, jaux = jmoe.moe_apply(_jnp(params), jnp.asarray(x),
                                dtype=jnp.float32, fused=False)
    got, taux = tmoe.moe_apply(_port(params), torch.from_numpy(x), dtype=F32,
                               fused=False)
    assert got.dtype == F32 and tuple(got.shape) == x.shape
    _close(got.numpy(), np.asarray(want), 0, 1e-5)
    _close(float(taux["moe_aux_loss"]), float(jaux["moe_aux_loss"]), 0, 1e-6)


def test_fused_matches_jax_fused_and_the_dense_path():
    _, jnp, jmoe = _jax()
    params, x = _setup()
    want, _ = jmoe.moe_apply_fused(_jnp(params), jnp.asarray(x),
                                   dtype=jnp.float32, interpret=True)
    tp, tx = _port(params), torch.from_numpy(x)
    got, _ = tmoe.moe_apply_fused(tp, tx, dtype=F32)
    dense, _ = tmoe.moe_apply(tp, tx, dtype=F32, fused=False)
    _close(got.numpy(), np.asarray(want), 0, 1e-5)
    _close(got.numpy(), dense.numpy(), 5e-6, 1e-6)


def _jax_kernel_case(params, x, factor=1.25):
    """JAX's routing of ``x`` with its lane-replicated metadata, as
    ``moe_apply_fused`` passes it to the Pallas kernels."""
    _, jnp, jmoe = _jax()
    gate, choice, pos, cap, _ = jmoe._route(_jnp(params), jnp.asarray(x),
                                            factor)
    t = choice.shape[0]
    cpad = max(jmoe.LANE, -(-cap // jmoe.LANE) * jmoe.LANE)
    reps = [jmoe._replicate(v, t, dt) for v, dt in
            ((choice, jnp.int32), (pos, jnp.int32), (gate, jnp.float32))]
    return (gate, choice, pos, cap, cpad, t), reps


def test_plain_kernels_are_bitwise_equal_to_jax_pallas_kernels():
    """The dispatched expert rows and the combined token rows, fp32: each
    element is one copy or one product in both, so bitwise (the Pallas
    kernels run in interpret mode; their capacity padding is cut off)."""
    _, jnp, jmoe = _jax()
    params, x = _setup()
    (gate, choice, pos, cap, cpad, t), (c_rep, p_rep, g_rep) = \
        _jax_kernel_case(params, x)
    e, d = params["wi"].shape[0], x.shape[-1]
    xf = x.reshape(t, d)
    want_in = np.asarray(jmoe._dispatch_call(
        jnp.asarray(xf), c_rep, p_rep, e, cap, cpad, t, True, jnp.float32))
    tc = torch.from_numpy(np.array(choice)).long()
    tpos = torch.from_numpy(np.array(pos)).long()
    got_in = tmoe.dispatch(torch.from_numpy(xf), tc, tpos, e, cap)
    assert np.array_equal(got_in.numpy(), want_in[:, :cap])
    assert not want_in[:, cap:].any()

    eo = np.random.default_rng(7).standard_normal((e, cpad, d),
                                                  dtype=np.float32)
    want_out = np.asarray(jmoe._combine_call(
        jnp.asarray(eo), c_rep, p_rep, g_rep, cap, t, True, jnp.float32))
    got_out = tmoe.combine(torch.from_numpy(eo[:, :cap].copy()), tc, tpos,
                           torch.from_numpy(np.array(gate)), cap)
    assert np.array_equal(got_out.numpy(), want_out)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plain_kernels_match_the_one_hot_contraction(dtype):
    """The plain B4a/B4b against the dense one-hot contraction of the same
    routing, bitwise: B4a against ``einsum(one_hot, x)`` in ``dtype``,
    B4b against ``einsum(one_hot * gate, expert_out)`` in fp32 rounded to
    ``dtype`` once (the kernel keeps the gate in fp32)."""
    params, x = _setup(experts=2, b=2, s=32)
    gate, choice, pos, cap, _ = tmoe._route(_port(params), torch.from_numpy(x),
                                            0.5)
    keep = pos < cap
    assert not bool(keep.all())              # the drop path is exercised
    e, t, d = 2, choice.shape[0], x.shape[-1]
    onehot = (torch.nn.functional.one_hot(choice, e).float()[:, :, None]
              * torch.nn.functional.one_hot(pos.clamp(0, cap - 1),
                                            cap).float()[:, None, :]
              * keep[:, None, None])
    xf = torch.from_numpy(x.reshape(t, d)).to(dtype)
    want_in = torch.einsum("tec,td->ecd", onehot.to(dtype), xf)
    got_in = tmoe._plain_dispatch(xf, choice, pos, e, cap, dtype)
    assert got_in.dtype == dtype and torch.equal(got_in, want_in)

    eo = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (e, cap, d), dtype=np.float32)).to(dtype)
    want_out = torch.einsum("tec,ecd->td", onehot * gate[:, None, None],
                            eo.float()).to(dtype)
    got_out = tmoe._plain_combine(eo, choice, pos, gate, cap, dtype)
    assert got_out.dtype == dtype and torch.equal(got_out, want_out)
    assert not got_out[~keep].any()


@pytest.mark.parametrize("types", sorted(tmoe.DISPATCH_TYPES, key=str))
def test_scaled_plain_dispatch_is_the_dispatch_of_the_product(types):
    """``scale`` multiplies each kept row in fp32 before the one
    conversion: bitwise the dispatch of ``x.float() * scale``."""
    tin, tout = types
    params, x = _setup(experts=2, b=2, s=32)
    _, choice, pos, cap, _ = tmoe._route(_port(params), torch.from_numpy(x),
                                         0.5)
    t, d = choice.shape[0], x.shape[-1]
    xt = torch.from_numpy(x.reshape(t, d)).to(tin)
    scale = torch.from_numpy(np.random.default_rng(5).standard_normal(
        t, dtype=np.float32))
    got = tmoe._plain_dispatch(xt, choice, pos, 2, cap, tout, scale)
    want = tmoe._plain_dispatch(xt.float() * scale[:, None], choice, pos, 2,
                                cap, tout)
    assert got.dtype == tout and torch.equal(got, want)
    assert torch.equal(tmoe.dispatch(xt, choice, pos, 2, cap, tout,
                                     scale=scale), got)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_scaled_dispatch_is_bitwise_equal_to_jax_dispatch_of_dout_times_gate(
        dtype):
    """The fused backward's dispatch (the cotangent in its own type, the
    gate as the scale) against the reference's ``_fused_combine_bwd``
    composition: JAX's Pallas ``_dispatch_call`` in interpret mode on
    ``dout32 * gate``, into ``dtype``."""
    _, jnp, jmoe = _jax()
    params, x = _setup()
    (gate, choice, pos, cap, cpad, t), (c_rep, p_rep, _) = \
        _jax_kernel_case(params, x)
    e, d = params["wi"].shape[0], x.shape[-1]
    dout = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (t, d), dtype=np.float32)).to(dtype)
    dout32 = dout.float().numpy()
    jdtype = jnp.float32 if dtype == F32 else jnp.bfloat16
    want = np.asarray(jmoe._dispatch_call(
        jnp.asarray(dout32) * gate[:, None], c_rep, p_rep, e, cap, cpad, t,
        True, jdtype).astype(jnp.float32))
    tc = torch.from_numpy(np.array(choice)).long()
    tpos = torch.from_numpy(np.array(pos)).long()
    got = tmoe.dispatch(dout, tc, tpos, e, cap, dtype,
                        scale=torch.from_numpy(np.array(gate)))
    assert got.dtype == dtype
    assert np.array_equal(got.float().numpy(), want[:, :cap])
    assert not want[:, cap:].any()


def test_path_helper_takes_the_vector_path_for_whole_aligned_chunks():
    """16-byte chunks of 8 elements: D = 768 (96 chunks) and D = 200 (25)
    take the vector path, D = 203 and a view 2 or 4 bytes off the
    allocation's 16-byte alignment take the scalar path."""
    for dtype in (F32, BF16):
        x = torch.zeros((4, 768), dtype=dtype)
        assert tmoe.vector_path(768, x)
        assert tmoe.vector_path(768, x, torch.zeros((2, 3, 768)))
        assert tmoe.vector_path(200, torch.zeros((4, 200), dtype=dtype))
        assert not tmoe.vector_path(203, torch.zeros((4, 203), dtype=dtype))
        flat = torch.zeros(4 * 768 + 8, dtype=dtype)
        view = flat[1:1 + 4 * 768].view(4, 768)
        assert view.is_contiguous() and view.data_ptr() % 16
        assert not tmoe.vector_path(768, view)
        assert not tmoe.vector_path(768, x, view)


def test_combine_backward_dispatches_the_cotangent_scaled_by_the_gate(
        monkeypatch):
    """``_Combine.backward`` hands the bf16 cotangent to the dispatch with
    the gate as its scale (no ``[T, D]`` fp32 product is built), and
    that dispatch is bitwise the dispatch of ``dout32 * gate``."""
    params, x = _setup(experts=2, b=2, s=32)
    seen = []
    real = tmoe.dispatch

    def spy(x, choice, pos, n_experts, capacity, out_dtype=None, scale=None):
        out = real(x, choice, pos, n_experts, capacity, out_dtype, scale)
        seen.append((x, choice, pos, n_experts, capacity, out_dtype, scale,
                     out))
        return out

    monkeypatch.setattr(tmoe, "dispatch", spy)
    tp = _port(params)
    tx = torch.from_numpy(x).requires_grad_()
    o, _ = tmoe.moe_apply_fused(tp, tx, capacity_factor=0.5, dtype=BF16)
    torch.autograd.grad((o.float() ** 2).sum(), [tx])
    assert len(seen) == 2 and seen[0][6] is None        # forward, backward
    dout, choice, pos, e, cap, out_dtype, scale, got = seen[1]
    assert dout.dtype == BF16 and out_dtype == BF16
    assert scale is not None and scale.dtype == F32
    want = tmoe._plain_dispatch(dout.float() * scale[:, None], choice, pos,
                                e, cap, BF16)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _jax_grads(params, x, fused):
    jax, jnp, jmoe = _jax()
    def loss(p, x):
        if fused:
            o, aux = jmoe.moe_apply_fused(p, x, dtype=jnp.float32,
                                          interpret=True)
        else:
            o, aux = jmoe.moe_apply(p, x, dtype=jnp.float32, fused=False)
        return (o.astype(jnp.float32) ** 2).sum() + aux["moe_aux_loss"]

    gp, gx = jax.grad(loss, argnums=(0, 1))(_jnp(params), jnp.asarray(x))
    return jax.tree_util.tree_map(np.asarray, gp), np.asarray(gx)


def _port_grads(params, x, fused):
    tp = _port(params)
    leaves = bridge.flatten(tp)
    for v in leaves.values():
        v.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    o, aux = tmoe.moe_apply(tp, tx, dtype=F32, fused=fused)
    loss = (o.float() ** 2).sum() + aux["moe_aux_loss"]
    grads = torch.autograd.grad(loss, list(leaves.values()) + [tx])
    return (bridge.unflatten(bridge.structure(tp),
                             {k: g.numpy() for k, g in zip(leaves, grads)}),
            grads[-1].numpy())


@pytest.fixture(scope="module")
def jax_grads():
    params, x = _setup()
    return {fused: _jax_grads(params, x, fused) for fused in (False, True)}


@pytest.mark.parametrize("port_fused", [False, True])
@pytest.mark.parametrize("jax_fused", [False, True])
def test_gradients_match_both_jax_formulations(jax_grads, port_fused,
                                                jax_fused):
    params, x = _setup()
    want_p, want_x = jax_grads[jax_fused]
    got_p, got_x = _port_grads(params, x, port_fused)
    _close(got_p["wi"], want_p["wi"], 1e-4, 1e-4, "wi")
    _close(got_p["wo"], want_p["wo"], 1e-4, 1e-4, "wo")
    _close(got_p["router"]["kernel"], want_p["router"]["kernel"], 1e-3, 1e-3,
           "router")
    _close(got_x, want_x, 1e-3, 1e-3, "x")


def test_router_gradient_flows_through_the_gate():
    """Without the aux loss the router learns only through the gate: its
    gradient must be nonzero on the fused path (a backward that skipped
    the gate's cotangent would leave it zero)."""
    params, x = _setup()
    tp = _port(params)
    router = tp["router"]["kernel"].requires_grad_()
    o, _ = tmoe.moe_apply_fused(tp, torch.from_numpy(x), dtype=F32)
    g, = torch.autograd.grad((o ** 2).sum(), [router])
    assert float(g.abs().max()) > 1e-3


def test_ragged_tokens_and_capacity_drops():
    """24 tokens (no tile divides them on the TPU) and capacity factor 0.5:
    the fused path matches JAX's and the port's dense one; dropped tokens
    give exact zero output rows and exact zero input-gradient rows."""
    _, jnp, jmoe = _jax()
    params, x = _setup(b=1, s=24)
    want, _ = jmoe.moe_apply_fused(_jnp(params), jnp.asarray(x),
                                   capacity_factor=0.5, dtype=jnp.float32,
                                   interpret=True, block_t=16)
    tp = _port(params)
    tx = torch.from_numpy(x).requires_grad_()
    got, _ = tmoe.moe_apply_fused(tp, tx, capacity_factor=0.5, dtype=F32)
    dense, _ = tmoe.moe_apply(tp, tx, capacity_factor=0.5, dtype=F32,
                              fused=False)
    _close(got.detach().numpy(), np.asarray(want), 0, 1e-5)
    _close(got.detach().numpy(), dense.detach().numpy(), 5e-6, 1e-6)
    _, _, pos, cap, _ = tmoe._route(tp, tx.detach(), 0.5)
    dropped = (pos >= cap).numpy().reshape(1, 24)
    assert dropped.any() and not dropped.all()
    assert not got.detach().numpy()[dropped].any()
    dx, = torch.autograd.grad((got ** 2).sum(), [tx])
    assert not dx.numpy()[dropped].any()
    assert dx.numpy()[~dropped].any()


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_compute_loose(fused):
    _, jnp, jmoe = _jax()
    params, x = _setup()
    if fused:
        want, _ = jmoe.moe_apply_fused(_jnp(params), jnp.asarray(x),
                                       dtype=jnp.bfloat16, interpret=True)
    else:
        want, _ = jmoe.moe_apply(_jnp(params), jnp.asarray(x),
                                 dtype=jnp.bfloat16, fused=False)
    got, _ = tmoe.moe_apply(_port(params), torch.from_numpy(x), dtype=BF16,
                            fused=fused)
    assert got.dtype == BF16
    _close(got.float().numpy(), np.asarray(want, np.float32), 0.05, 0.05)


# ---------------------------------------------------------------------------
# dispatch rule
# ---------------------------------------------------------------------------

def test_fused_supports_and_env_dispatch(monkeypatch):
    assert not tmoe.fused_supports((2, 64, 128), 4, "cpu")
    assert tmoe.fused_supports((2, 64, 128), 4, "cuda")
    assert tmoe.fused_supports((1, 3, 5), 1, torch.device("cuda"))
    assert not tmoe.fused_supports((128, 128), 4, "cuda")
    assert not tmoe.fused_supports((2, 64, 128), 0, "cuda")

    params, x = _setup(experts=2, b=2, s=32)
    tp, tx = _port(params), torch.from_numpy(x)
    calls = []
    real = tmoe.moe_apply_fused
    monkeypatch.setattr(tmoe, "moe_apply_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    before = dict(real.launches)
    dense, _ = tmoe.moe_apply(tp, tx, dtype=F32, fused=False)
    fused, _ = tmoe.moe_apply(tp, tx, dtype=F32, fused=True)
    assert calls == [1]
    _close(fused.numpy(), dense.numpy(), 5e-6, 1e-6)
    # TPUJOB_MOE_FUSED=1 is read at call time, and CPU tensors are refused
    monkeypatch.setenv("TPUJOB_MOE_FUSED", "1")
    env, _ = tmoe.moe_apply(tp, tx, dtype=F32)
    assert calls == [1] and torch.equal(env, dense)
    monkeypatch.setattr(tmoe, "fused_supports", lambda *a: True)
    tmoe.moe_apply(tp, tx, dtype=F32)
    assert calls == [1, 1]
    monkeypatch.setenv("TPUJOB_MOE_FUSED", "0")
    tmoe.moe_apply(tp, tx, dtype=F32)
    assert calls == [1, 1]
    # CPU tensors take the plain versions and count no launch
    assert real.launches == before


def test_moe_init_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(gen, 64, 256, 8)
    assert p["router"]["kernel"].shape == (64, 8)
    assert p["wi"].shape == (8, 64, 256) and p["wo"].shape == (8, 256, 64)
    assert abs(float(p["wi"].std()) - (2 / 64) ** 0.5) < 0.01
    assert abs(float(p["wo"].std()) - (2 / 256) ** 0.5) < 0.01
    limit = (6 / (64 + 8)) ** 0.5
    assert float(p["router"]["kernel"].abs().max()) <= limit


# ---------------------------------------------------------------------------
# the CUDA kernels (need a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MoE kernels have no CPU mode")
    return torch.device("cuda")


def _kernel_case(device, t=1000, d=200, e=8, factor=0.5, seed=0,
                 skew=False):
    """Routing of ``t`` tokens over ``e`` experts at ``factor``: random
    choices with positions from the cumulative count, as ``_route`` makes
    them (capacity ``factor * t / e``, so some tokens drop). ``skew``
    sends every second token to expert 0, so that at ``factor`` 1 expert
    0 drops tokens and the others leave slots empty."""
    rng = np.random.default_rng(seed)
    choice = torch.from_numpy(rng.integers(0, e, t)).to(device)
    if skew:
        choice[::2] = 0
    onehot = torch.nn.functional.one_hot(choice, e)
    pos = (torch.cumsum(onehot, 0) * onehot - 1).max(-1).values
    cap = max(1, int(factor * t / e))
    gate = torch.from_numpy(rng.random(t, dtype=np.float32)).to(device)
    x = torch.from_numpy(rng.standard_normal((t, d), dtype=np.float32))
    eo = torch.from_numpy(rng.standard_normal((e, cap, d), dtype=np.float32))
    return x.to(device), eo.to(device), choice, pos, cap, gate


#: D of the kernel cases: 96 and 25 chunks (vector path), 203 (scalar)
CASE_DIMS = (768, 200, 203)


def _path_counts():
    return dict(tmoe.moe_apply_fused.path_launches)


def _path(kernel, d):
    """The path count a launch of ``kernel`` on aligned rows of ``d``
    elements adds to."""
    return "%s_%s" % (kernel, "vector" if d % tmoe.VECTOR == 0 else "scalar")


def _took(before, key):
    """The path counts since ``before`` are one launch, counted at
    ``key``."""
    now = tmoe.moe_apply_fused.path_launches
    return {k: now[k] - before[k] for k in now} == {
        k: int(k == key) for k in now}


@pytest.mark.cuda
@pytest.mark.parametrize("d", CASE_DIMS)
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("types", sorted(tmoe.DISPATCH_TYPES, key=str))
@pytest.mark.parametrize("t", [1000, 16384])
def test_cuda_dispatch_is_bitwise_equal_to_plain(cuda_device, types, t,
                                                 scaled, d):
    x, _, choice, pos, cap, gate = _kernel_case(cuda_device, t=t, d=d)
    x = x.to(types[0])
    scale = gate - 0.5 if scaled else None
    before = tmoe.moe_apply_fused.launches["dispatch"]
    paths = _path_counts()
    got = tmoe._launch_dispatch(x, choice, pos, 8, cap, types[1], scale)
    want = tmoe._plain_dispatch(x, choice, pos, 8, cap, types[1], scale)
    torch.cuda.synchronize()
    assert tmoe.moe_apply_fused.launches["dispatch"] == before + 1
    assert _took(paths, _path("dispatch", d))
    assert got.dtype == types[1] and torch.equal(got, want)
    assert bool((pos >= cap).any())


@pytest.mark.cuda
@pytest.mark.parametrize("d", CASE_DIMS)
@pytest.mark.parametrize("types", sorted(tmoe.COMBINE_TYPES, key=str))
@pytest.mark.parametrize("gated", [False, True])
def test_cuda_combine_is_bitwise_equal_to_plain(cuda_device, types, gated,
                                                d):
    _, eo, choice, pos, cap, gate = _kernel_case(cuda_device, t=999, d=d)
    eo = eo.to(types[0])
    g = gate if gated else None
    paths = _path_counts()
    got = tmoe._launch_combine(eo, choice, pos, g, cap, types[1])
    want = tmoe._plain_combine(eo, choice, pos, g, cap, types[1])
    torch.cuda.synchronize()
    assert _took(paths, _path("combine", d))
    assert got.dtype == types[1] and torch.equal(got, want)
    assert not got[pos >= cap].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_misaligned_view_takes_the_scalar_path(cuda_device, dtype):
    """A contiguous view one element past a 16-byte boundary: both
    kernels take the scalar path on it and stay bitwise equal to plain."""
    x, eo, choice, pos, cap, gate = _kernel_case(cuda_device, d=768)
    t, d = x.shape
    flat = torch.zeros(t * d + 8, dtype=dtype, device=cuda_device)
    xv = flat[1:1 + t * d].view(t, d)
    xv.copy_(x)
    assert xv.data_ptr() % 16
    paths = _path_counts()
    got = tmoe._launch_dispatch(xv, choice, pos, 8, cap, dtype, gate)
    want = tmoe._plain_dispatch(xv, choice, pos, 8, cap, dtype, gate)
    torch.cuda.synchronize()
    assert _took(paths, "dispatch_scalar")
    assert torch.equal(got, want)

    e_flat = torch.zeros(eo.numel() + 8, dtype=dtype, device=cuda_device)
    ev = e_flat[1:1 + eo.numel()].view(eo.shape)
    ev.copy_(eo)
    paths = _path_counts()
    got = tmoe._launch_combine(ev, choice, pos, gate, cap, dtype)
    want = tmoe._plain_combine(ev, choice, pos, gate, cap, dtype)
    torch.cuda.synchronize()
    assert _took(paths, "combine_scalar")
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["T=0", "T=1", "all_dropped"])
def test_cuda_edge_token_counts(cuda_device, case):
    """No token, one token, and every token dropped: dispatch writes an
    all-zero ``[E, C, D]`` where no token is kept, combine a zero row for
    each dropped token."""
    t = {"T=0": 0, "T=1": 1, "all_dropped": 1000}[case]
    x, _, choice, pos, cap, gate = _kernel_case(cuda_device, t=t, d=768)
    if case == "all_dropped":
        pos = pos + cap
    eo = torch.randn((8, cap, 768), device=cuda_device)
    for dtype in (F32, BF16):
        got = tmoe._launch_dispatch(x.to(dtype), choice, pos, 8, cap, dtype,
                                    gate)
        want = tmoe._plain_dispatch(x.to(dtype), choice, pos, 8, cap, dtype,
                                    gate)
        out = tmoe._launch_combine(eo.to(dtype), choice, pos, gate, cap,
                                   dtype)
        ref = tmoe._plain_combine(eo.to(dtype), choice, pos, gate, cap,
                                  dtype)
        torch.cuda.synchronize()
        assert got.shape == (8, cap, 768) and torch.equal(got, want)
        assert out.shape == (t, 768) and torch.equal(out, ref)
    if case != "T=1":
        assert not got.any() and not out.any()


@pytest.mark.cuda
def test_cuda_dispatch_ignores_a_stale_slot_table(cuda_device):
    """Dispatch never clears its slot table: each entry counts only if its
    token's own routing is kept at that slot. The launch is given a table
    that holds another routing's entries (every kept token one slot on,
    ids past T, negative ids); the gather must still be bitwise plain,
    and the entries it had to reject are still there after it."""
    x, _, choice, pos, cap, gate = _kernel_case(cuda_device, t=1000, d=768,
                                                factor=1.0, skew=True)
    keep = pos < cap
    slots = 8 * cap
    owned = torch.zeros(slots, dtype=torch.bool, device=cuda_device)
    owned[(choice * cap + pos)[keep]] = True
    stale = torch.full((slots,), 999_999, dtype=torch.int32,
                       device=cuda_device)
    stale[::3] = -7
    tokens = torch.arange(1000, device=cuda_device, dtype=torch.int32)
    stale[(choice * cap + pos + 1)[keep] % slots] = tokens[keep]
    assert bool((~owned & (stale >= 0) & (stale < 1000)).any())
    assert bool((~owned & (stale < 0)).any())
    for scale in (None, gate):
        table = stale.clone()
        out = torch.empty((8, cap, 768), dtype=F32, device=cuda_device)
        tmoe._dispatch_into(x, choice, pos, scale, table, out)
        want = tmoe._plain_dispatch(x, choice, pos, 8, cap, F32, scale)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert torch.equal(table[~owned], stale[~owned])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [768, 203])
def test_cuda_outputs_are_written_whole(cuda_device, monkeypatch, d):
    """With deterministic algorithms and ``fill_uninitialized_memory``
    on, ``torch.empty`` fills the kernels' outputs with NaN, and
    dispatch's slot table with INT_MAX, before the launch: every empty
    slot and every dropped row must come back +0.0, so each kernel writes
    its whole output (dispatch has no zero fill of its own), and the
    gather rejects a table entry that names no token."""
    x, eo, choice, pos, cap, gate = _kernel_case(cuda_device, d=d,
                                                 factor=1.0, skew=True)
    monkeypatch.setattr(torch.utils.deterministic,
                        "fill_uninitialized_memory", True)
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        assert torch.isnan(torch.empty(4, device=cuda_device)).all()
        for dtype in (F32, BF16):
            got = tmoe._launch_dispatch(x.to(dtype), choice, pos, 8, cap,
                                        dtype, gate)
            out = tmoe._launch_combine(eo.to(dtype), choice, pos, gate,
                                       cap, dtype)
            torch.cuda.synchronize()
            slots = torch.zeros((8, cap), dtype=torch.bool,
                                device=cuda_device)
            keep = pos < cap
            slots[choice[keep], pos[keep]] = True
            assert bool((~slots).any()) and bool((~keep).any())
            for rows in (got[~slots], out[~keep]):
                assert not torch.isnan(rows).any()
                assert not rows.any() and not torch.signbit(rows).any()
            assert torch.equal(got, tmoe._plain_dispatch(
                x.to(dtype), choice, pos, 8, cap, dtype, gate))
            assert torch.equal(out, tmoe._plain_combine(
                eo.to(dtype), choice, pos, gate, cap, dtype))
    finally:
        torch.use_deterministic_algorithms(saved)


def _plain_dispatch(x, choice, pos, n_experts, capacity, out_dtype=None,
                    scale=None):
    return tmoe._plain_dispatch(x, choice, pos, n_experts, capacity,
                                out_dtype or x.dtype, scale)


def _plain_combine(eo, choice, pos, gate, capacity, out_dtype=None):
    return tmoe._plain_combine(eo, choice, pos, gate, capacity,
                               out_dtype or eo.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_autograd_matches_plain_autograd(cuda_device, monkeypatch,
                                              dtype):
    """The fused layer on the card (kernels forward and backward) against
    the same layer with the kernels' plain versions run on the card."""
    params = bridge.params_to_numpy(
        tmoe.moe_init(torch.Generator().manual_seed(0), 256, 512, 8))
    x = np.random.default_rng(1).standard_normal((4, 128, 256),
                                                 dtype=np.float32)

    def run():
        tp = bridge.params_from_numpy(params, device=cuda_device)
        leaves = bridge.flatten(tp)
        for v in leaves.values():
            v.requires_grad_()
        tx = torch.from_numpy(x).to(cuda_device).requires_grad_()
        before = dict(tmoe.moe_apply_fused.launches)
        o, aux = tmoe.moe_apply_fused(tp, tx, dtype=dtype)
        loss = (o.float() ** 2).sum() + aux["moe_aux_loss"]
        grads = torch.autograd.grad(loss, list(leaves.values()) + [tx])
        return o.detach(), grads, {k: tmoe.moe_apply_fused.launches[k]
                                   - before[k] for k in before}

    o_k, g_k, n_k = run()
    monkeypatch.setattr(tmoe, "dispatch", _plain_dispatch)
    monkeypatch.setattr(tmoe, "combine", _plain_combine)
    o_p, g_p, n_p = run()
    assert n_k == {"dispatch": 2, "combine": 3}
    assert n_p == {"dispatch": 0, "combine": 0}
    assert torch.equal(o_k, o_p)
    for a, b in zip(g_k, g_p):
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_cuda_kernels_refuse_what_they_do_not_take(cuda_device):
    x, eo, choice, pos, cap, gate = _kernel_case(cuda_device)
    with pytest.raises(TypeError):
        tmoe._launch_dispatch(x.to(BF16), choice, pos, 8, cap, F32)
    with pytest.raises(TypeError):
        tmoe._launch_combine(eo, choice, pos, gate, cap, BF16)
    with pytest.raises(TypeError):
        tmoe._launch_dispatch(x.double(), choice, pos, 8, cap, torch.float64)
    with pytest.raises(ValueError):
        tmoe._launch_dispatch(x, choice.int(), pos, 8, cap, F32)
    with pytest.raises(ValueError):
        tmoe._launch_dispatch(x, choice, pos.cpu(), 8, cap, F32)
    with pytest.raises(ValueError):
        tmoe._launch_dispatch(x[None], choice, pos, 8, cap, F32)
    with pytest.raises(ValueError):
        tmoe._launch_combine(eo, choice, pos, gate.to(BF16), cap, F32)
    with pytest.raises(ValueError):
        tmoe._launch_combine(eo, choice, pos, gate, cap + 1, F32)
