"""The fused-SGD CUDA kernel of the port (``csrc/fused_sgd.cu``) against
its plain PyTorch version.

The kernel's per-leaf descriptor table is built in Python and checked
here on the CPU. The kernel itself has no CPU mode: the ``cuda``-marked
tests skip without a card and, on one, hold the kernel against the plain
version bitwise (both round every product and sum alone, in the same
order). Run them on the card with
``python -m pytest tests/test_torch_fused_sgd.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch.ops import optim as topt


def test_descriptor_table_chunks_never_straddle_leaves():
    sizes = [0, 1, topt._CHUNK, topt._CHUNK + 1, 3 * topt._CHUNK - 1, 5]
    ps = [torch.zeros(n) for n in sizes]
    gs = [None if i % 2 else torch.zeros(n) for i, n in enumerate(sizes)]
    ms = [torch.zeros(n) for n in sizes]
    table, chunks = topt._descriptor_table(ps, gs, ms, [1e-4] * len(sizes))
    want = np.cumsum([0] + [-(-n // topt._CHUNK) for n in sizes])
    assert table.shape == (len(sizes), topt._TABLE_COLS)
    assert list(table[:, 5]) == list(want[:-1]) and chunks == want[-1]
    assert list(table[:, 3]) == sizes
    assert (table[1::2, 1] == 0).all()          # None grads: null pointers
    assert np.float32(1e-4).view(np.int32) == table[0, 4]


# ---------------------------------------------------------------------------
# the CUDA kernel (needs a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _ragged_leaves(device, seed=0):
    rng = np.random.default_rng(seed)
    sizes = [64 * 7 * 7 * 3, 1, 64, 0, 4096, 4097, 256 * 1000, 1000, 12345]
    ps = [torch.from_numpy(rng.standard_normal(n, dtype=np.float32))
          .to(device) for n in sizes]
    gs = [None if i in (2, 5) else torch.from_numpy(
        rng.standard_normal(n, dtype=np.float32)).to(device)
        for i, n in enumerate(sizes)]
    ms = [torch.zeros_like(p) for p in ps]
    decays = [1e-4 if i % 3 else 0.0 for i in range(len(sizes))]
    return ps, gs, ms, decays


@pytest.mark.cuda
@pytest.mark.parametrize("nesterov", [False, True])
def test_cuda_kernel_is_bitwise_equal_to_plain(cuda_device, nesterov):
    ps, gs, ms, decays = _ragged_leaves(cuda_device)
    ps2 = [p.clone() for p in ps]
    ms2 = [m.clone() for m in ms]
    sched = topt.cosine_schedule(0.4, 5, 1)
    before = topt.multi_tensor_sgd.launches
    for step in range(1, 6):
        lr = sched(torch.tensor(step, device=cuda_device))
        topt.multi_tensor_sgd(ps, gs, ms, decays, lr, 0.9, nesterov)
        topt._plain_multi_tensor_sgd(ps2, gs, ms2, decays, lr, 0.9, nesterov)
        torch.cuda.synchronize()
        for a, b in zip(ps + ms, ps2 + ms2):
            assert torch.equal(a, b)
    assert topt.multi_tensor_sgd.launches == before + 5


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take(cuda_device):
    ps, gs, ms, decays = _ragged_leaves(cuda_device)
    lr = torch.tensor(0.1, device=cuda_device)
    with pytest.raises(TypeError):
        topt.multi_tensor_sgd([p.double() for p in ps], gs, ms, decays, lr,
                              0.9)
    with pytest.raises(ValueError):
        topt.multi_tensor_sgd(ps, gs, ms, decays, lr.cpu(), 0.9)
    with pytest.raises(ValueError):
        topt.multi_tensor_sgd([ps[0][::2]], [None], [ms[0][::2]], [0.0], lr,
                              0.9)
