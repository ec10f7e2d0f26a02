"""GPT causal-LM training entry of the port, on one CUDA device:

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

Not ported yet: ``TPUJOB_SP > 1`` (ring attention over a sequence mesh)
raises. The train step is single-device, so the reference's sharding
rules (``gpt_rules``, and ``moe_rules``' expert axis) and mesh axes are
not carried.
"""

import logging
import os
from typing import Any, Mapping, Optional

from paddle_operator_tpu_torch.models import gpt
from paddle_operator_tpu_torch.ops import optim
from paddle_operator_tpu_torch.runner import TrainJob, run_training


def _int(env: Mapping[str, str], knob: str, default: int) -> int:
    return int(env.get(knob) or default)


def make_job(env: Optional[Mapping[str, str]] = None,
             attn_impl: Any = "auto") -> TrainJob:
    """The TrainJob of the example, from ``env`` (default: the process
    environment). ``attn_impl`` is the attention the loss runs: "auto"
    (the kernels on CUDA) unless a caller compares paths."""
    env = os.environ if env is None else env
    if _int(env, "TPUJOB_SP", 1) > 1:
        raise NotImplementedError(
            "TPUJOB_SP>1 (sequence-parallel ring attention) is not ported "
            "yet; the port's train step is single-device")
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

    def loss_fn(p, b):
        return gpt.loss_fn(p, b, remat=True, attn_impl=attn_impl,
                           ce_chunk=ce_chunk)

    return TrainJob(
        init_params=lambda gen: gpt.init(gen, cfg),
        loss_fn=loss_fn,
        optimizer=optim.adamw(
            optim.cosine_schedule(3e-4, steps, steps // 10),
            weight_decay=0.1),
        make_batch=lambda gen, step: gpt.synthetic_batch(
            gen, batch, seq, cfg["vocab_size"]),
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
