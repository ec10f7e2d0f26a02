"""Ring and Ulysses attention of the torch port
(``paddle_operator_tpu_torch/parallel/context.py``) across four real
worker processes (``python -m paddle_operator_tpu_torch.launch`` with the
operator's env, gloo on the CPU), against the JAX package's
``parallel/context.py`` on the conftest's CPU devices.

One world of four workers (``paddle_operator_tpu_torch/dp_check.py``,
scenario ``attn``) runs every case of this file; each worker takes its
block of seeded global inputs (numpy, fp32) on a mesh ``{"sp": 4}`` or
``{"dp": 2, "sp": 2}`` (sp 4 and sp 2), runs the port's function on it
and differentiates ``sum(out * g)``. The blocks, put together, are held
against the same global inputs through the JAX function on an ``sp``
mesh of as many devices and through its ``reference_attention``: the
forward within 2e-5, the gradients of q, k and v within 2e-4 (the
classes of ``tests/test_context_parallel.py``). Cases: the blockwise
ring against JAX's blockwise ring, the flash ring (the kernels' plain
versions on the CPU) against JAX's ``ring_flash_attention`` (Pallas in
interpret mode), Ulysses against JAX's Ulysses, causal and not. A ring
whose causal test on rotated hops is reversed (a planted fault) must
fall outside the class.
"""

import concurrent.futures
import functools
import os

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import dp_check
from paddle_operator_tpu_torch.parallel import context
from paddle_operator_tpu_torch.parallel.mesh import Mesh

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from paddle_operator_tpu.parallel import context as jctx  # noqa: E402
from paddle_operator_tpu.parallel import mesh as jmesh  # noqa: E402

FWD_TOL, GRAD_TOL = 2e-5, 2e-4
#: (function, impl, global [B, H, S, D]): the flash ring's blocks are
#: whole kernel tiles (S/n a multiple of 128), Ulysses' heads split 4 ways
SHAPES = {("ring", "blockwise"): (2, 4, 64, 16),
          ("ring", "flash"): (1, 2, 512, 16),
          ("ulysses", "blockwise"): (2, 8, 64, 16),
          ("ulysses", "flash"): (1, 8, 256, 64)}
MESHES = {4: {"sp": 4}, 2: {"dp": 2, "sp": 2}}
#: sp 4 and sp 2, causal and not (Ulysses' flash path: causal)
CASES = {"%s_%s_sp%d_%s" % (fn, impl, n, "causal" if causal else "full"):
         dict(fn=fn, impl=impl, n=n, causal=causal)
         for (fn, impl) in SHAPES for n in MESHES for causal in (False, True)
         if causal or (fn, impl) != ("ulysses", "flash")}
FAULT = "ring_flash_sp4_causal"


def _case(name):
    c = CASES[name]
    return dict(c, shape=SHAPES[(c["fn"], c["impl"])], seed=len(name))


def _jax_fn(c):
    """The JAX function of case ``c`` on an sp mesh of c["n"] devices."""
    mesh = jmesh.make_mesh({"sp": c["n"]}, jax.devices()[:c["n"]])
    fn = {"ring": jctx.ring_attention, "ulysses": jctx.ulysses_attention}
    return functools.partial(fn[c["fn"]], mesh=mesh, axis="sp",
                             causal=c["causal"], impl=c["impl"])


def _jax_run(fn, case):
    """Output and gradients of ``sum(fn(q, k, v) * g)`` in JAX."""
    x = {k: jnp.asarray(v) for k, v in case.items()}

    def loss(q, k, v):
        out = fn(q, k, v)
        return (out.astype(jnp.float32) * x["g"]).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(x["q"], x["k"], x["v"])
    return {"out": np.asarray(out),
            **{k: np.asarray(g) for k, g in zip(("dq", "dk", "dv"), grads)}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case (and the planted fault) in one four-worker world, while
    JAX computes each case's function and reference."""
    out = str(tmp_path_factory.mktemp("context"))
    scenarios = []
    for name in CASES:
        c = _case(name)
        scenarios.append(dict(kind="attn", name=name, fn=c["fn"],
                              impl=c["impl"], shape=c["shape"],
                              causal=c["causal"], seed=c["seed"],
                              mesh=MESHES[c["n"]]))
    faulty = next(dict(sc) for sc in scenarios if sc["name"] == FAULT)
    scenarios.append(dict(faulty, name="fault", fault="causal_flipped"))
    ref = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        workers = pool.submit(
            dp_check.launch_workers, {"out": out, "scenarios": scenarios},
            world=4, backend="gloo", timeout=300,
            env={"OMP_NUM_THREADS": "2"})
        for name in CASES:
            c = _case(name)
            inputs = dp_check.attn_case(c["shape"], c["seed"])
            ref[name] = {
                "jax": _jax_run(_jax_fn(c), inputs),
                "reference": _jax_run(functools.partial(
                    jctx.reference_attention, causal=c["causal"]), inputs)}
        workers.result()
    return {"out": out, "ref": ref}


def _assembled(world, name):
    """The case's blocks put together: rank r of a ``{"sp": 4}`` mesh, or
    of dp replica 0 of ``{"dp": 2, "sp": 2}``, holds sequence block r; the
    second replica's blocks must equal the first's bit for bit."""
    n = CASES[name if name in CASES else FAULT]["n"]
    got = [dp_check.load_tree(os.path.join(world["out"], "%s.rank%d.npz"
                                           % (name, r))) for r in range(4)]
    if n == 2:
        for a, b in zip(got[:2], got[2:]):
            for k in a:
                assert np.array_equal(a[k], b[k]), k
    return {k: np.concatenate([g[k] for g in got[:n]], axis=2)
            for k in got[0]}


def _close(got, want):
    np.testing.assert_allclose(got["out"], want["out"], atol=FWD_TOL,
                               rtol=FWD_TOL)
    for k in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_function(world, name):
    _close(_assembled(world, name), world["ref"][name]["jax"])


@pytest.mark.parametrize("name", list(CASES))
def test_matches_reference_attention(world, name):
    _close(_assembled(world, name), world["ref"][name]["reference"])


def test_reversed_causal_test_is_rejected(world):
    got = _assembled(world, "fault")
    with pytest.raises(AssertionError):
        _close(got, world["ref"][FAULT]["jax"])


def test_port_reference_attention_matches_jax():
    case = dp_check.attn_case((2, 4, 64, 16), seed=3)
    for causal in (False, True):
        want = np.asarray(jctx.reference_attention(
            *(jnp.asarray(case[k]) for k in "qkv"), causal=causal))
        got = context.reference_attention(
            *(torch.from_numpy(case[k]) for k in "qkv"), causal=causal)
        np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL,
                                   rtol=FWD_TOL)


def test_errors_match_reference():
    """The reference's errors: a sequence that does not divide the ring
    (here where the global tensor is cut into blocks), heads that do not
    divide the sp size, and an unknown impl."""
    mesh4 = Mesh({"sp": 4})
    x = torch.zeros(1, 2, 62, 8)
    with pytest.raises(ValueError, match="divide"):
        context.local_block(x, mesh4)
    with pytest.raises(AssertionError):
        jctx.ring_attention(*(jnp.zeros((1, 2, 62, 8)),) * 3,
                            jmesh.make_mesh({"sp": 4}, jax.devices()[:4]))
    q = torch.zeros(1, 6, 16, 8)
    with pytest.raises(ValueError, match="heads 6 must divide sp size 4"):
        context.ulysses_attention(q, q, q, mesh4)
    with pytest.raises(AssertionError, match="heads 6 must divide"):
        jctx.ulysses_attention(*(jnp.zeros((1, 6, 64, 8)),) * 3,
                               jmesh.make_mesh({"sp": 4}, jax.devices()[:4]))
    with pytest.raises(ValueError, match="impl"):
        context.ring_attention(q, q, q, mesh4, impl="dense")
    # a mesh built outside a process group has no group to run over
    with pytest.raises(ValueError, match="no process group"):
        context.ring_attention(q, q, q, mesh4, impl="blockwise")


def test_one_rank_is_plain_attention():
    """A mesh of one: no collective, the ring is the local computation."""
    case = dp_check.attn_case((1, 2, 256, 16), seed=4)
    q, k, v = (torch.from_numpy(case[n]) for n in "qkv")
    want = context.reference_attention(q, k, v, causal=True)
    for impl in ("blockwise", "flash"):
        got = context.ring_attention(q, k, v, Mesh({"sp": 1}), causal=True,
                                     impl=impl)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_TOL,
                                   rtol=FWD_TOL)
