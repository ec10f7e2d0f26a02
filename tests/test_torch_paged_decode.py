"""Paged decode attention of the torch port against the JAX package.

On the CPU the port's ``paged_decode_attention`` takes its plain version;
it must match both the JAX gather-einsum reference and the Pallas kernel
in interpret mode within 1e-5 (the JAX package's own tolerance for the
kernel). The CUDA kernel is held against the plain version on the card by
the ``cuda``-marked tests, which skip where there is no card.
"""

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch.ops import attention
from paddle_operator_tpu_torch.testing import PAGED_CASES, paged_decode_case

TOL = 1e-5


def _torch_case(case, device="cpu"):
    return [torch.from_numpy(case[k]).to(device)
            for k in ("q", "k_pages", "v_pages", "tables", "lens")]


def test_supports_paged_rule():
    assert attention.supports_paged((3, 2, 64), 8)
    assert attention.supports_paged((3, 2, 256), 16)
    assert not attention.supports_paged((3, 2, 48), 8)
    assert not attention.supports_paged((3, 2, 64), 6)
    assert not attention.supports_paged((3, 64), 8)


@pytest.mark.parametrize("name", ["ragged", "bs16_d128"])
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
def test_cuda_kernel_refuses_what_it_does_not_take(cuda_device):
    q, kp, vp, tables, lens = _torch_case(paged_decode_case("ragged"),
                                          cuda_device)
    with pytest.raises(TypeError):
        attention.paged_decode_attention(q.double(), kp.double(),
                                         vp.double(), tables, lens)
    with pytest.raises(ValueError):        # head_dim 48 has no kernel
        attention.paged_decode_attention(q[..., :48], kp[..., :48],
                                         vp[..., :48], tables, lens)
