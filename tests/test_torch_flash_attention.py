"""Flash attention of the torch port against the JAX package.

On the CPU the port's ``flash_attention`` and ``flash_attention_lse`` run
their plain versions; forward, LSE and the grads of q, k and v must match
the JAX Pallas kernels in interpret mode within atol 2e-5 in fp32, the
JAX package's own kernel-vs-reference bound
(``tests/test_pallas_attention.py``). Inputs and cotangents are made with
numpy from a seed; the JAX side runs with ``block_q != block_k``.

The bf16 kernels B2a, B2b and B2c run on the tensor cores with P and dS
split into bf16 hi + lo; ``testing.mma_flash_fwd`` / ``mma_flash_dq`` /
``mma_flash_dkv`` model that rounding on the CPU, and the tests hold the
model to the bf16 rule against the plain versions (and show that one bf16
rounding breaks it).

The ``cuda``-marked tests hold each CUDA kernel (B2a forward, B2b dQ,
B2c dK/dV of ``csrc/flash_attention.cu``) against its plain version on
the card, in fp32 and bf16, and skip where there is none.
"""

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import testing
from paddle_operator_tpu_torch.ops import attention

ATOL = 2e-5
CASES = [(s, causal, d) for s in (256, 384) for causal in (False, True)
         for d in (64, 128)]


def _inputs(s, d, b=1, h=2, seed=0):
    """q, k, v, the output cotangent and an LSE cotangent, fp32 numpy."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, h, s, d), dtype=np.float32)
                  for _ in range(4))
    g_lse = rng.standard_normal((b, h, s), dtype=np.float32)
    return q, k, v, g, g_lse


def _jax_blocks(s, causal):
    """Unequal JAX tiles: a 128-row q tile and a whole-sequence kv tile,
    or the other way round."""
    return (128, s) if causal else (s, 128)


def _jax_flash(q, k, v, g, g_lse, causal, with_lse):
    import jax
    import jax.numpy as jnp

    from paddle_operator_tpu.ops import attention_pallas as ap

    bq, bk = _jax_blocks(q.shape[2], causal)
    kw = dict(block_q=bq, block_k=bk, interpret=True, causal=causal)

    def loss(q, k, v):
        if with_lse:
            out, lse = ap.flash_attention_lse(q, k, v, **kw)
            return jnp.sum(out * g) + jnp.sum(lse * g_lse), (out, lse)
        out = ap.flash_attention(q, k, v, **kw)
        return jnp.sum(out * g), (out,)

    grads, outs = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in outs], [np.asarray(x) for x in grads]


def _port_flash(q, k, v, g, g_lse, causal, with_lse, device="cpu"):
    qt, kt, vt = (torch.from_numpy(x).to(device).requires_grad_()
                  for x in (q, k, v))
    gt = torch.from_numpy(g).to(device)
    if with_lse:
        out, lse = attention.flash_attention_lse(qt, kt, vt, causal=causal)
        loss = torch.sum(out * gt) + torch.sum(
            lse * torch.from_numpy(g_lse).to(device))
        outs = [out, lse]
    else:
        out = attention.flash_attention(qt, kt, vt, causal=causal)
        loss = torch.sum(out * gt)
        outs = [out]
    grads = torch.autograd.grad(loss, (qt, kt, vt))
    return ([x.detach().cpu().numpy() for x in outs],
            [x.cpu().numpy() for x in grads])


def _max_err(got, want):
    return float(np.max(np.abs(got - want)))


@pytest.mark.parametrize("s,causal,d", CASES)
def test_flash_attention_matches_jax(s, causal, d):
    pytest.importorskip("jax")
    q, k, v, g, g_lse = _inputs(s, d)
    want_outs, want_grads = _jax_flash(q, k, v, g, g_lse, causal, False)
    got_outs, got_grads = _port_flash(q, k, v, g, g_lse, causal, False)
    assert got_outs[0].shape == q.shape and got_outs[0].dtype == np.float32
    assert _max_err(got_outs[0], want_outs[0]) < ATOL
    for name, got, want in zip("qkv", got_grads, want_grads):
        assert _max_err(got, want) < ATOL, name


@pytest.mark.parametrize("s,causal,d", [(256, False, 64), (384, True, 128)])
def test_flash_attention_lse_matches_jax(s, causal, d):
    pytest.importorskip("jax")
    q, k, v, g, g_lse = _inputs(s, d, seed=1)
    want_outs, want_grads = _jax_flash(q, k, v, g, g_lse, causal, True)
    got_outs, got_grads = _port_flash(q, k, v, g, g_lse, causal, True)
    assert got_outs[1].shape == q.shape[:3]
    for got, want in zip(got_outs + got_grads, want_outs + want_grads):
        assert _max_err(got, want) < ATOL


def test_plain_forward_matches_reference_attention():
    q, k, v, _, _ = _inputs(256, 64, seed=2)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    for causal in (False, True):
        want = attention._reference_attention(qt, kt, vt, 0.125, causal)
        got, lse = attention._plain_flash_fwd(qt, kt, vt, 0.125, causal)
        assert _max_err(got.numpy(), want.numpy()) < ATOL
        assert lse.shape == (1, 2, 256) and lse.dtype == torch.float32


def test_supports_predicate():
    # the cases of tests/test_pallas_attention.py::test_supports_predicate
    assert attention.supports((2, 4, 256, 64), torch.bfloat16)
    assert attention.supports((2, 4, 512, 128), torch.bfloat16)
    assert not attention.supports((2, 4, 100, 64), torch.bfloat16)
    assert not attention.supports((2, 4, 128, 64), torch.bfloat16)
    assert not attention.supports((2, 4, 256, 48), torch.bfloat16)
    assert not attention.supports((4, 256, 64), torch.bfloat16)


@pytest.mark.parametrize("block_q,block_k,ok", [
    (None, None, True), (128, 256, True), (256, 128, True),
    (64, 128, False), (128, 192, False), (384, 128, False)])
def test_check_blocks_as_the_reference(block_q, block_k, ok):
    q = torch.zeros((1, 1, 256, 64))
    if ok:
        attention.flash_attention(q, q, q, block_q=block_q, block_k=block_k)
    else:
        with pytest.raises(ValueError):
            attention.flash_attention(q, q, q, block_q=block_q,
                                      block_k=block_k)
    with pytest.raises(ValueError):     # 200 does not tile by 128
        attention.flash_attention(*(torch.zeros((1, 1, 200, 64)),) * 3)


def test_cpu_path_does_not_count_launches():
    before = dict(attention.flash_attention.launches)
    q, k, v, g, g_lse = _inputs(256, 64)
    _port_flash(q, k, v, g, g_lse, True, True)
    assert attention.flash_attention.launches == before


# ---------------------------------------------------------------------------
# the bf16 rule the card's comparison uses, and the faults it must reject
# ---------------------------------------------------------------------------

def _bf16_plain(q, k, v, g, scale):
    """The plain versions in fp32 on bf16 inputs, as the card runs them:
    O and LSE, and dQ/dK/dV on that LSE and delta = rowsum(dO * O) of the
    bf16 O; outputs in bf16, with (LSE, delta)."""
    out, lse = attention._plain_flash_fwd(q, k, v, scale, True)
    delta = torch.sum(g.float() * out.float(), dim=-1)
    args = (q, k, v, g, lse, delta, scale, True)
    dk, dv = attention._plain_flash_dkv(*args)
    return ({"o": out, "dq": attention._plain_flash_dq(*args), "dk": dk,
             "dv": dv}, (lse, delta))


def _fp64_flash(q, k, v, g, lse, delta, scale):
    """The same formulas in fp64 (another rounding of every sum), the
    backward on the given LSE and delta; outputs rounded to bf16."""
    q, k, v, g = (x.double() for x in (q, k, v, g))
    s = attention._causal_mask(torch.matmul(q, k.transpose(-1, -2)) * scale)
    p = torch.exp(s - lse.double()[..., None])
    ds = p * (torch.matmul(g, v.transpose(-1, -2)) - delta.double()[..., None])
    got = {"o": torch.matmul(torch.softmax(s, dim=-1), v),
           "dq": torch.matmul(ds, k) * scale,
           "dk": torch.matmul(ds.transpose(-1, -2), q) * scale,
           "dv": torch.matmul(p.transpose(-1, -2), g)}
    return {n: x.bfloat16() for n, x in got.items()}


def _bf16_case(s=256, d=64, seed=4):
    q, k, v, g, _ = _inputs(s, d, seed=seed)
    inputs = [torch.from_numpy(x).bfloat16() for x in (q, k, v, g)]
    return inputs, d ** -0.5


def test_bf16_ulp():
    x = torch.tensor([1.0, 0.75, -3.0, 0.0, 2.0 ** -20],
                     dtype=torch.bfloat16)
    assert testing.bf16_ulp(x).tolist() == [2.0 ** -7, 2.0 ** -8,
                                            2.0 ** -6, 0.0, 2.0 ** -27]
    # a bf16 value and its neighbour part by exactly one ulp: worst 1 - eps
    one = torch.tensor([1.0], dtype=torch.bfloat16)
    up = one + 2.0 ** -7
    assert up.dtype == torch.bfloat16 and up.item() == 1.0 + 2.0 ** -7
    assert 0.99 < testing.bf16_errors(up, one)["worst"] <= 1.0
    assert testing.bf16_errors(one + 2.0 ** -6, one)["worst"] > 1.0


def test_bf16_rule_holds_another_summation_order():
    """The plain versions against the same formulas in fp64 on the same
    bf16 inputs and backward operands, as the card holds each kernel
    against its plain version: every output within the rule."""
    (q, k, v, g), scale = _bf16_case()
    want, (lse, delta) = _bf16_plain(q, k, v, g, scale)
    got = _fp64_flash(q, k, v, g, lse, delta, scale)
    for name, w in want.items():
        errors = testing.bf16_errors(got[name], w)
        assert errors["worst"] <= 1.0 and errors["outside"] == 0, name


@pytest.mark.parametrize("fault", ["causal_edge_off_by_one",
                                   "misscaled_tile"])
def test_bf16_rule_rejects_planted_faults(fault):
    """A causal mask that reaches one key too far, or one 64-row tile
    scaled by 1 + 2^-6: every output falls outside the rule."""
    (q, k, v, g), scale = _bf16_case()
    want, _ = _bf16_plain(q, k, v, g, scale)
    if fault == "causal_edge_off_by_one":
        got = testing.causal_attention_autograd(q, k, v, g, scale, edge=1)
    else:
        got = {name: testing.misscaled_tile(w) for name, w in want.items()}
    for name, w in want.items():
        assert testing.bf16_errors(got[name], w)["worst"] > 1.0, name


def test_autograd_attention_matches_plain_in_fp32():
    """``causal_attention_autograd`` with its edge on the diagonal is the
    attention the plain versions compute (fp32, within 2e-5)."""
    q, k, v, g, _ = _inputs(256, 64, seed=5)
    q, k, v, g = (torch.from_numpy(x) for x in (q, k, v, g))
    got = testing.causal_attention_autograd(q, k, v, g, 0.125)
    out, lse = attention._plain_flash_fwd(q, k, v, 0.125, True)
    args = (q, k, v, g, lse, torch.sum(g * out, dim=-1), 0.125, True)
    want = dict(zip(("o", "dq", "dk", "dv"),
                    (out, attention._plain_flash_dq(*args),
                     *attention._plain_flash_dkv(*args))))
    for name, w in want.items():
        assert _max_err(got[name].numpy(), w.numpy()) < ATOL, name


def test_plain_forward_matches_interpret_pallas_forward():
    """``_plain_flash_fwd``, the yardstick the card holds kernel B2a to,
    against the JAX package's forward kernel in interpret mode: O and LSE
    within 2e-5 in fp32."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from paddle_operator_tpu.ops import attention_pallas as ap

    q, k, v, _, _ = _inputs(256, 64, seed=6)
    for causal in (False, True):
        bq, bk = _jax_blocks(256, causal)
        out, lse = ap.flash_attention_lse(
            *(jnp.asarray(x) for x in (q, k, v)), block_q=bq, block_k=bk,
            interpret=True, causal=causal)
        got, got_lse = attention._plain_flash_fwd(
            *(torch.from_numpy(x) for x in (q, k, v)), 0.125, causal)
        assert _max_err(got.numpy(), np.asarray(out)) < ATOL
        assert _max_err(got_lse.numpy(), np.asarray(lse)) < ATOL


def _mma_case(causal, seed=11):
    """bf16 inputs at 2 x 4 x 1024 x 64 from a seed, the plain forward,
    and the backward's operands on its O and LSE."""
    q, k, v, g, _ = _inputs(1024, 64, b=2, h=4, seed=seed)
    q, k, v, g = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    out, lse = attention._plain_flash_fwd(q, k, v, 0.125, causal)
    delta = torch.sum(g.float() * out.float(), dim=-1)
    return (q, k, v, g), (out, lse), (q, k, v, g, lse, delta, 0.125, causal)


def _mma_errors(causal, split):
    """The rounding model of the bf16 tensor-core kernels against the
    plain versions, by output."""
    (q, k, v, _), (out, lse), args = _mma_case(causal)
    got_out, got_lse = testing.mma_flash_fwd(q, k, v, 0.125, causal, split)
    got_dq = testing.mma_flash_dq(*args, split=split)
    got_dk, got_dv = testing.mma_flash_dkv(*args, split=split)
    want_dk, want_dv = attention._plain_flash_dkv(*args)
    return ({"o": testing.bf16_errors(got_out, out),
             "dq": testing.bf16_errors(got_dq,
                                       attention._plain_flash_dq(*args)),
             "dk": testing.bf16_errors(got_dk, want_dk),
             "dv": testing.bf16_errors(got_dv, want_dv)},
            _max_err(got_lse.numpy(), lse.numpy()))


@pytest.mark.parametrize("causal", [False, True])
def test_split_bf16_products_hold_the_bf16_rule(causal):
    """P and dS split into bf16 hi + lo, as kernels B2a, B2b and B2c carry
    them to the tensor cores: O, dQ, dK and dV within one bf16 ulp of the
    plain versions plus ``testing.BF16_ATOL``, LSE within 2e-5."""
    errors, lse_err = _mma_errors(causal, split=True)
    for name, e in errors.items():
        assert e["worst"] <= 1.0 and e["outside"] == 0, (name, e)
    assert lse_err < ATOL


@pytest.mark.parametrize("causal", [False, True])
def test_single_bf16_rounding_breaks_the_bf16_rule(causal):
    """P and dS rounded once to bf16: O, dQ, dK and dV fall outside the
    rule by tens of ulps, which is why the kernels split them."""
    errors, _ = _mma_errors(causal, split=False)
    for name, e in errors.items():
        assert e["worst"] > 10.0 and e["outside"] > 1000, (name, e)


def test_bf16_parts():
    x = torch.tensor([1.0 + 2.0 ** -12, -3.0, 0.0, 1e-3])
    hi, lo = testing.bf16_parts(x)
    assert hi.tolist() == x.bfloat16().float().tolist()
    assert hi[0].item() == 1.0 and lo[0].item() == 2.0 ** -12
    assert torch.all(torch.abs(hi + lo - x) <= 2.0 ** -17 * torch.abs(x))
    assert len(testing.bf16_parts(x, split=False)) == 1


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_inputs(device, s, d, dtype, b=2, h=4, seed=0):
    q, k, v, g, _ = _inputs(s, d, b=b, h=h, seed=seed)
    return [torch.from_numpy(x).to(device, dtype) for x in (q, k, v, g)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,s,d", [
    (torch.float32, 128, 64), (torch.float32, 512, 64),
    (torch.float32, 512, 128), (torch.float32, 512, 256),
    (torch.bfloat16, 512, 64), (torch.bfloat16, 512, 128),
    (torch.bfloat16, 512, 256)])
def test_cuda_kernels_match_plain(cuda_device, causal, dtype, s, d):
    """fp32 (SIMT kernels): every output within 2e-5 of the plain
    version's largest magnitude (or of 1, if larger). bf16 (B2a, B2b and
    B2c on the tensor cores): each bf16 output element within one bf16 ulp
    of the plain value plus ``testing.BF16_ATOL``, LSE as in fp32.
    S = 128 is valid for the reference's flash_attention though mha's
    ``supports`` wants 256."""
    q, k, v, g = _card_inputs(cuda_device, s, d, dtype)
    scale = d ** -0.5
    before = dict(attention.flash_attention.launches)
    out, lse = attention._launch_fwd(q, k, v, scale, causal)
    want_out, want_lse = attention._plain_flash_fwd(q, k, v, scale, causal)
    delta = torch.sum(g.float() * out.float(), dim=-1)
    args = (q, k, v, g, lse, delta, scale, causal)
    dq = attention._launch_dq(*args)
    dk, dv = attention._launch_dkv(*args)
    want_dq = attention._plain_flash_dq(*args)
    want_dk, want_dv = attention._plain_flash_dkv(*args)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == {
        key: n + 1 for key, n in before.items()}
    for got, want in ((out, want_out), (lse, want_lse), (dq, want_dq),
                      (dk, want_dk), (dv, want_dv)):
        assert got.shape == want.shape and got.dtype == want.dtype
        if got.dtype == torch.bfloat16:
            errors = testing.bf16_errors(got, want)
            assert errors["worst"] <= 1.0, errors
        else:
            bound = ATOL * max(1.0, torch.max(torch.abs(want)).item())
            assert torch.max(torch.abs(got - want)).item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_bf16_kernels_are_deterministic(cuda_device, d):
    """B2a, B2b and B2c launched twice on the same bf16 inputs give the
    same bits: no atomics, a fixed summation order (the GPT resume gate
    relies on it)."""
    q, k, v, g = _card_inputs(cuda_device, 512, d, torch.bfloat16, seed=9)
    scale = d ** -0.5
    outs = []
    for _ in range(2):
        out, lse = attention._launch_fwd(q, k, v, scale, True)
        delta = torch.sum(g.float() * out.float(), dim=-1)
        args = (q, k, v, g, lse, delta, scale, True)
        outs.append((out, lse, attention._launch_dq(*args),
                     *attention._launch_dkv(*args)))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_bf16_autograd_matches_plain(cuda_device):
    """bf16 through the autograd entry point, one launch of each kernel:
    O against the plain forward and the grads against the plain backward
    on the kernels' own O and LSE, element by element within one bf16 ulp
    of the plain value plus ``testing.BF16_ATOL``."""
    q, k, v, g = _card_inputs(cuda_device, 256, 64, torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(attention.flash_attention.launches)
    out = attention.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == {
        key: n + 1 for key, n in before.items()}
    lse = attention._launch_fwd(q, k, v, 0.125, True)[1]
    delta = torch.sum(g.float() * out.detach().float(), dim=-1)
    args = (q, k, v, g, lse, delta, 0.125, True)
    wants = [attention._plain_flash_fwd(q, k, v, 0.125, True)[0],
             attention._plain_flash_dq(*args),
             *attention._plain_flash_dkv(*args)]
    for got, want in zip([out, *grads], wants):
        assert got.dtype == torch.bfloat16
        errors = testing.bf16_errors(got, want)
        assert errors["worst"] <= 1.0, errors


@pytest.mark.cuda
def test_cuda_kernels_refuse_what_they_do_not_take(cuda_device):
    q, k, v, _ = _card_inputs(cuda_device, 256, 64, torch.float32)
    with pytest.raises(TypeError):
        attention._launch_fwd(q.half(), k.half(), v.half(), 0.125, False)
    with pytest.raises(ValueError):        # head_dim 48 has no kernel
        attention._launch_fwd(q[..., :48], k[..., :48], v[..., :48], 0.125,
                              False)
    with pytest.raises(ValueError):        # S = 192 is no whole tile
        attention._launch_fwd(q[:, :, :192], k[:, :, :192], v[:, :, :192],
                              0.125, False)
    with pytest.raises(ValueError):        # k of another type than q
        attention._launch_fwd(q, k.bfloat16(), v, 0.125, False)


@pytest.mark.cuda
def test_cuda_kernels_and_plain_versions_count_the_same_flops(cuda_device):
    """The flash operators report the same FLOPs to FlopCounterMode
    whether the kernels (CUDA tensors) or the plain versions (CPU tensors)
    run: a step counts the same FLOPs on either path."""
    from torch.utils.flop_counter import FlopCounterMode

    counts = {}
    for dev in (cuda_device, torch.device("cpu")):
        q, k, v, g = _card_inputs(dev, 512, 64, torch.bfloat16)
        for t in (q, k, v):
            t.requires_grad_()
        before = dict(attention.flash_attention.launches)
        with FlopCounterMode(display=False) as counter:
            out = attention.flash_attention(q, k, v, causal=True)
            out.backward(g)
        counts[dev.type] = counter.get_total_flops()
        launched = {key: n - before[key] for key, n in
                    attention.flash_attention.launches.items()}
        assert launched == ({"fwd": 1, "dq": 1, "dkv": 1}
                            if dev.type == "cuda" else
                            {"fwd": 0, "dq": 0, "dkv": 0})
    assert counts["cuda"] == counts["cpu"] == \
        12 * 2 * 4 * 64 * attention.attention_pairs(512, True)
