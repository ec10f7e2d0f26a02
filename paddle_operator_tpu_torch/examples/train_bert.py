"""BERT-base masked-LM training entry of the port, on one CUDA device:

    python -m paddle_operator_tpu_torch.examples.train_bert

The counterpart of ``examples/train_bert.py``: the same env vars
(``TPUJOB_BATCH`` 64, ``TPUJOB_SEQ`` 512, ``TPUJOB_STEPS`` 100,
``TPUJOB_STEPS_PER_CALL``, ``TPUJOB_CHECKPOINT_DIR``), ``adamw`` with
``cosine_schedule(1e-4, STEPS, STEPS // 10)`` and weight decay 0.01,
``grad_clip=1.0``, remat on, bf16 compute on fp32 master parameters.
Synthetic batches (15 % of the positions in the loss, an all-ones
attention mask) are drawn on the card from ``(seed, step)``. The mask
takes the einsum attention, as in the reference, so this path launches
no kernel of the port.

Like the reference's example it has no MoE knob: BERT-base with MoE FFNs
is a ``TrainJob`` over ``bert.init(dict(BASE_CONFIG, moe_experts=8,
moe_every=2))``. The job carries the reference's rules, ``bert_rules()``:
on a mesh with a ``tp`` axis (a caller's ``mesh_axes``, e.g. ``{"tp":
4}``) each worker holds its heads and MLP columns, and its tiles of the
vocabulary where 30522 divides by tp (at tp 4 the embedding and the MLM
decoder stay whole); on a mesh without tp they are dropped.
"""

import logging
import os
from typing import Mapping, Optional

from paddle_operator_tpu_torch.models import bert
from paddle_operator_tpu_torch.ops import optim
from paddle_operator_tpu_torch.parallel import sharding
from paddle_operator_tpu_torch.runner import TrainJob, run_training


def _int(env: Mapping[str, str], knob: str, default: int) -> int:
    return int(env.get(knob) or default)


def make_job(env: Optional[Mapping[str, str]] = None) -> TrainJob:
    """The TrainJob of the example, from ``env`` (default: the process
    environment)."""
    env = os.environ if env is None else env
    batch = _int(env, "TPUJOB_BATCH", 64)
    seq = _int(env, "TPUJOB_SEQ", 512)
    steps = _int(env, "TPUJOB_STEPS", 100)
    return TrainJob(
        init_params=lambda gen: bert.init(gen),
        loss_fn=lambda p, b: bert.loss_fn(p, b, remat=True),
        optimizer=optim.adamw(
            optim.cosine_schedule(1e-4, steps, steps // 10),
            weight_decay=0.01),
        make_batch=lambda gen, step: bert.synthetic_batch(
            gen, batch, seq, bert.BASE_CONFIG["vocab_size"]),
        grad_clip=1.0,
        rules=sharding.bert_rules(),
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
