"""Paged decode attention of the torch port against the JAX package.

On the CPU the port's ``paged_decode_attention`` takes its plain version;
it must match both the JAX gather-einsum reference and the Pallas kernel
in interpret mode within 1e-5 (the JAX package's own tolerance for the
kernel) in fp32, and within the bf16 rule (``testing.bf16_errors``) where
the output is bf16. Lengths of 0 (the mean of V over the table: every
slot ties at the finite NEG_INF) and past ``T * bs`` are among the cases.
The CUDA kernel is held against the plain version on the card by the
``cuda``-marked tests, over the four pairings of fp32 and bf16 q and
pages, and they skip where there is no card.
"""

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import testing
from paddle_operator_tpu_torch.ops import attention
from paddle_operator_tpu_torch.testing import PAGED_CASES, paged_decode_case

TOL = 1e-5
#: (q, pages) types the kernel takes
TYPE_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
              (torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16)]


def _torch_case(case, device="cpu", q_dtype=torch.float32,
                kv_dtype=torch.float32):
    q, kp, vp, tables, lens = (
        torch.from_numpy(case[k]).to(device)
        for k in ("q", "k_pages", "v_pages", "tables", "lens"))
    return [q.to(q_dtype), kp.to(kv_dtype), vp.to(kv_dtype), tables, lens]


def _assert_close(got, want):
    """fp32 outputs within TOL, bf16 ones within the bf16 rule."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.bfloat16:
        errors = testing.bf16_errors(got, want)
        assert errors["worst"] <= 1.0 and errors["outside"] == 0, errors
    else:
        assert torch.max(torch.abs(got - want)).item() < TOL


def test_supports_paged_rule():
    assert attention.supports_paged((3, 2, 64), 8)
    assert attention.supports_paged((3, 2, 256), 16)
    assert not attention.supports_paged((3, 2, 48), 8)
    assert not attention.supports_paged((3, 2, 64), 6)
    assert not attention.supports_paged((3, 64), 8)


@pytest.mark.parametrize("name", ["ragged", "bs16_d128", "edge_lens"])
def test_plain_matches_jax_reference_and_interpret_kernel(name):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from paddle_operator_tpu.ops import attention_pallas as ap

    case = paged_decode_case(name)
    d = case["q"].shape[-1]
    scale = 1.0 / np.sqrt(d)
    args = [jnp.asarray(case[k]) for k in
            ("q", "k_pages", "v_pages", "tables", "lens")]
    want_ref = np.asarray(ap._reference_paged_decode(*args, scale))
    want_kernel = np.asarray(jax.block_until_ready(
        ap.paged_decode_attention(*args, interpret=True)))
    got = attention.paged_decode_attention(*_torch_case(case)).numpy()
    assert got.shape == case["q"].shape and got.dtype == np.float32
    assert np.max(np.abs(got - want_ref)) < TOL
    assert np.max(np.abs(got - want_kernel)) < TOL
    # the plain version alone, with the scale passed explicitly
    plain = attention._reference_paged_decode(*_torch_case(case), scale)
    assert np.max(np.abs(plain.numpy() - want_ref)) < TOL


@pytest.mark.parametrize("name", ["ragged", "edge_lens"])
@pytest.mark.parametrize("q_dtype,kv_dtype", TYPE_PAIRS[1:])
def test_plain_matches_jax_in_bf16(name, q_dtype, kv_dtype):
    """bf16 q or pages through both sides: the JAX reference and the
    interpret-mode Pallas kernel cast them to fp32 and return q's type, as
    the port's plain version does; fp32 outputs within 1e-5, bf16 ones
    within the bf16 rule."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from paddle_operator_tpu.ops import attention_pallas as ap

    jnp_types = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    case = paged_decode_case(name)
    args = [jnp.asarray(case["q"]).astype(jnp_types[q_dtype]),
            *(jnp.asarray(case[k]).astype(jnp_types[kv_dtype])
              for k in ("k_pages", "v_pages")),
            jnp.asarray(case["tables"]), jnp.asarray(case["lens"])]
    scale = 1.0 / np.sqrt(case["q"].shape[-1])
    got = attention.paged_decode_attention(
        *_torch_case(case, q_dtype=q_dtype, kv_dtype=kv_dtype))
    assert got.dtype == q_dtype
    for want in (ap._reference_paged_decode(*args, scale),
                 jax.block_until_ready(
                     ap.paged_decode_attention(*args, interpret=True))):
        want = torch.from_numpy(np.array(want.astype(jnp.float32)))
        _assert_close(got, want.to(q_dtype))


def test_edge_lengths_follow_the_reference_mask():
    """A length of 0 gives the mean of V over all T * bs slots of the table
    (every score is NEG_INF and they tie); a length past T * bs counts as
    T * bs."""
    case = paged_decode_case("edge_lens")
    q, kp, vp, tables, lens = _torch_case(case)
    got = attention.paged_decode_attention(q, kp, vp, tables, lens)
    t, bs = tables.shape[1], kp.shape[1]
    for i in torch.nonzero(lens == 0)[:, 0].tolist():
        want = vp[tables[i].long()].reshape(t * bs, *vp.shape[2:]).mean(0)
        assert torch.max(torch.abs(got[i] - want)).item() < TOL
    past = int(torch.nonzero(lens > t * bs)[0, 0])
    clamped = lens.clone()
    clamped[past] = t * bs
    want = attention.paged_decode_attention(q, kp, vp, tables, clamped)
    assert torch.equal(got[past], want[past])


def test_paged_split_covers_the_table_in_whole_pages():
    for bs in (8, 16, 24, 64, 128):
        for t in (1, 3, 4, 5, 64, 65):
            pages, splits = attention.paged_split(bs, t)
            assert pages >= 1 and (splits - 1) * pages < t <= splits * pages
            assert pages * bs <= max(attention.PAGED_SPLIT_TOKENS, bs)
    assert attention.paged_split(16, 64) == (8, 8)    # the engine's shape


def test_cpu_path_does_not_count_launches():
    before = attention.paged_decode_attention.launches
    attention.paged_decode_attention(*_torch_case(paged_decode_case("ragged")))
    assert attention.paged_decode_attention.launches == before


@pytest.mark.parametrize("bad", ["heads", "batch", "lens"])
def test_shape_checks_raise(bad):
    q, kp, vp, tables, lens = _torch_case(paged_decode_case("ragged"))
    if bad == "heads":
        kp = kp[:, :, :1]
    elif bad == "batch":
        tables = tables[:2]
    else:
        lens = lens[:, None]
    with pytest.raises(ValueError):
        attention.paged_decode_attention(q, kp, vp, tables, lens)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", PAGED_CASES)
def test_cuda_kernel_matches_plain(cuda_device, name):
    case = paged_decode_case(name)
    args = _torch_case(case, cuda_device)
    before = attention.paged_decode_attention.launches
    got = attention.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert attention.paged_decode_attention.launches == before + 1
    scale = 1.0 / np.sqrt(case["q"].shape[-1])
    want = attention._reference_paged_decode(*args, scale)
    assert torch.max(torch.abs(got - want)).item() < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", TYPE_PAIRS)
@pytest.mark.parametrize("name", PAGED_CASES)
def test_cuda_kernel_takes_fp32_and_bf16(cuda_device, name, q_dtype,
                                         kv_dtype):
    """Every pairing of fp32 and bf16 q and pages: the output in q's type,
    fp32 within 1e-5 of the plain version, bf16 within the bf16 rule."""
    case = paged_decode_case(name)
    args = _torch_case(case, cuda_device, q_dtype, kv_dtype)
    got = attention.paged_decode_attention(*args)
    scale = 1.0 / np.sqrt(case["q"].shape[-1])
    want = attention._reference_paged_decode(*args, scale)
    torch.cuda.synchronize()
    _assert_close(got, want)


def _split_edge_case(device, q_dtype, kv_dtype):
    """Lengths on the edges of the kernel's split over pages (1, split - 1,
    split, split + 1, T * bs) and 0, at bs = 16 and a table of two splits."""
    bs = 16
    pages = attention.paged_split(bs, 1)[0]
    split, t = pages * bs, 2 * pages
    lens = np.asarray([1, split - 1, split, split + 1, t * bs, 0],
                      dtype=np.int32)
    b, h, d, pool = len(lens), 2, 64, len(lens) * t + 3
    rng = np.random.default_rng(3)
    case = {"q": rng.standard_normal((b, h, d), dtype=np.float32),
            "k_pages": rng.standard_normal((pool, bs, h, d),
                                           dtype=np.float32),
            "v_pages": rng.standard_normal((pool, bs, h, d),
                                           dtype=np.float32),
            "tables": rng.permutation(pool)[:b * t].reshape(b, t).astype(
                np.int32),
            "lens": lens}
    return _torch_case(case, device, q_dtype, kv_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", TYPE_PAIRS)
def test_cuda_kernel_at_the_split_edges(cuda_device, q_dtype, kv_dtype):
    args = _split_edge_case(cuda_device, q_dtype, kv_dtype)
    got = attention.paged_decode_attention(*args)
    want = attention._reference_paged_decode(*args, 0.125)
    torch.cuda.synchronize()
    _assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", TYPE_PAIRS)
def test_cuda_zero_length_is_the_mean_of_v(cuda_device, q_dtype, kv_dtype):
    """A sequence of length 0 on the card: the plain version's mean of V over
    the table's T * bs slots, not a zero row."""
    q, kp, vp, tables, lens = _torch_case(paged_decode_case("edge_lens"),
                                          cuda_device, q_dtype, kv_dtype)
    got = attention.paged_decode_attention(q, kp, vp, tables, lens)
    want = attention._reference_paged_decode(q, kp, vp, tables, lens, 0.125)
    torch.cuda.synchronize()
    zero = lens == 0
    assert bool(zero.any())
    mean = vp[tables[zero].long()].float().mean(dim=(1, 2))
    _assert_close(got[zero], want[zero])
    _assert_close(got[zero], mean.to(q_dtype))
    assert torch.count_nonzero(got[zero]).item() == got[zero].numel()


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", TYPE_PAIRS)
def test_cuda_kernel_is_deterministic(cuda_device, q_dtype, kv_dtype):
    """Two launches on the same inputs give the same bits: no atomics, the
    splits merged in a fixed order."""
    args = _torch_case(paged_decode_case("full_width"), cuda_device, q_dtype,
                       kv_dtype)
    first = attention.paged_decode_attention(*args)
    second = attention.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take(cuda_device):
    q, kp, vp, tables, lens = _torch_case(paged_decode_case("ragged"),
                                          cuda_device)
    with pytest.raises(TypeError):
        attention.paged_decode_attention(q.double(), kp.double(),
                                         vp.double(), tables, lens)
    with pytest.raises(TypeError):         # k and v pages of two types
        attention.paged_decode_attention(q, kp.bfloat16(), vp, tables, lens)
    with pytest.raises(ValueError):        # head_dim 48 has no kernel
        attention.paged_decode_attention(q[..., :48], kp[..., :48],
                                         vp[..., :48], tables, lens)
