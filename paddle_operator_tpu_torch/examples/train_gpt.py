"""GPT causal-LM training entry of the port, on one CUDA device or one a
worker:

    python -m paddle_operator_tpu_torch.examples.train_gpt

The counterpart of ``examples/train_gpt.py``: the same env vars
(``TPUJOB_BATCH`` 16, ``TPUJOB_SEQ`` 1024, ``TPUJOB_STEPS`` 100,
``TPUJOB_LAYERS/HIDDEN/HEADS/MLP_DIM/VOCAB`` over GPT-2 small's
``BASE_CONFIG``, ``TPUJOB_CE_CHUNK`` 1024 (0 takes the dense LM head),
``TPUJOB_STEPS_PER_CALL``, ``TPUJOB_CHECKPOINT_DIR``), ``adamw`` with
``cosine_schedule(3e-4, STEPS, STEPS // 10)`` and weight decay 0.1,
``grad_clip=1.0``, remat on, bf16 compute on fp32 master parameters, and
``attn_impl="auto"``: the flash-attention CUDA kernels. Synthetic batches
are drawn on the card from ``(seed, step)``.

``TPUJOB_MOE_EXPERTS=N`` makes every second FFN a switch-MoE block of N
experts (``moe_every=2``); ``TPUJOB_MOE_FUSED=1``, read when the loss
runs, takes the MoE dispatch/combine CUDA kernels in place of the dense
einsum formulation.

Under ``python -m paddle_operator_tpu_torch.launch`` with several
workers, ``run_training`` splits the global batch (``TPUJOB_BATCH``)
over a ``dp`` mesh. ``TPUJOB_SP > 1`` is the long-context mode, as in
the reference: the mesh is ``{"dp": -1, "sp": SP}``, each worker holds
1/SP of every sequence, and attention is causal ring attention over
``sp`` (:func:`..parallel.context.ring_attention`: the flash kernels on
every hop on CUDA), with ``seq_axis="sp"``. MoE layers route over the
global batch under dp and dp x sp. The job carries the reference's rules,
``gpt_rules() + moe_rules()``: on a mesh with an ``ep`` axis (a caller's
``mesh_axes``, e.g. ``{"dp": 2, "ep": 2}``, as the reference's tests
build it; there is no env knob for it) each worker holds its block of
every MoE layer's experts, and on a mesh with a ``tp`` axis (``{"dp": 2,
"tp": 2}``, again from the caller's ``mesh_axes``) each worker holds its
heads, its MLP columns and its vocabulary tiles of the dense model and
computes on them (Megatron's layout, :mod:`..parallel.train`); a MoE
layer, which no tp rule splits, runs whole on every tp rank. The axes
combine (``{"tp": 2, "sp": 2, "ep": 2}`` with ``TPUJOB_SP=2``). The
rules over an axis the mesh lacks are dropped.
"""

import functools
import logging
import os
from typing import Any, Mapping, Optional

from paddle_operator_tpu_torch.models import gpt
from paddle_operator_tpu_torch.ops import optim
from paddle_operator_tpu_torch.parallel import context, sharding
from paddle_operator_tpu_torch.runner import TrainJob, run_training


def _int(env: Mapping[str, str], knob: str, default: int) -> int:
    return int(env.get(knob) or default)


def make_job(env: Optional[Mapping[str, str]] = None,
             attn_impl: Any = "auto") -> TrainJob:
    """The TrainJob of the example, from ``env`` (default: the process
    environment). ``attn_impl`` is the attention the loss runs without
    a sequence split: "auto" (the kernels on CUDA) unless a caller
    compares paths; with ``TPUJOB_SP > 1`` it is ring attention over the
    mesh's sp axis."""
    env = os.environ if env is None else env
    sp = _int(env, "TPUJOB_SP", 1)
    batch = _int(env, "TPUJOB_BATCH", 16)
    seq = _int(env, "TPUJOB_SEQ", 1024)
    steps = _int(env, "TPUJOB_STEPS", 100)
    cfg = dict(gpt.BASE_CONFIG, max_seq=seq)
    for knob, key in (("TPUJOB_LAYERS", "layers"), ("TPUJOB_HIDDEN", "hidden"),
                      ("TPUJOB_HEADS", "heads"), ("TPUJOB_MLP_DIM", "mlp_dim"),
                      ("TPUJOB_VOCAB", "vocab_size")):
        if env.get(knob):
            cfg[key] = int(env[knob])
    experts = _int(env, "TPUJOB_MOE_EXPERTS", 0)
    if experts:
        cfg.update(moe_experts=experts, moe_every=2)
    # stream tokens through the LM head (never materialise [B, S, V] fp32
    # logits); 0 restores the dense path
    ce_chunk = _int(env, "TPUJOB_CE_CHUNK", 1024)

    def loss_fn(p, b, mesh=None):
        attn = attn_impl
        if mesh is not None and sp > 1 and "sp" in mesh.shape:
            attn = functools.partial(context.ring_attention, mesh=mesh,
                                     axis="sp", causal=True)
        return gpt.loss_fn(p, b, remat=True, attn_impl=attn,
                           ce_chunk=ce_chunk)

    return TrainJob(
        init_params=lambda gen: gpt.init(gen, cfg),
        loss_fn=loss_fn,
        optimizer=optim.adamw(
            optim.cosine_schedule(3e-4, steps, steps // 10),
            weight_decay=0.1),
        make_batch=lambda gen, step: gpt.synthetic_batch(
            gen, batch, seq, cfg["vocab_size"]),
        mesh_axes={"dp": -1, "sp": sp} if sp > 1 else None,
        seq_axis="sp" if sp > 1 else None,
        rules=sharding.gpt_rules() + sharding.moe_rules(),
        grad_clip=1.0,
        total_steps=steps,
        steps_per_call=_int(env, "TPUJOB_STEPS_PER_CALL", 1),
        checkpoint_dir=env.get("TPUJOB_CHECKPOINT_DIR", ""),
    )


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    out = run_training(make_job())
    print("final loss:", out.get("loss"))


if __name__ == "__main__":
    main()
