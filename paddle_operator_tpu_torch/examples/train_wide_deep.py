"""wide_and_deep CTR training entry of the port, on one CUDA device or
one a worker:

    python -m paddle_operator_tpu_torch.examples.train_wide_deep
    python -m paddle_operator_tpu_torch.launch \\
        paddle_operator_tpu_torch/examples/train_wide_deep.py   # in a pod

The counterpart of ``examples/train_wide_deep.py``, the collective-mode
twin of the PS-mode workload (``train_wide_deep_ps.py``): the same env
vars (``TPUJOB_BATCH`` 512, the global batch over every worker,
``TPUJOB_STEPS`` 100, ``TPUJOB_STEPS_PER_CALL``), ``adamw(1e-3)``,
synthetic batches, bf16 compute on fp32 master parameters, through
``run_training``. Under ``launch`` with several workers ``run_training``
splits the batch over a ``dp`` mesh; the reference's ``ctr_rules`` shard
the tables only over ``tp``, which a dp mesh lacks, so they mean
"replicated" there and are not carried.
"""

import logging
import os
from typing import Mapping, Optional

from paddle_operator_tpu_torch.models import wide_deep
from paddle_operator_tpu_torch.ops import optim
from paddle_operator_tpu_torch.runner import TrainJob, run_training


def make_job(env: Optional[Mapping[str, str]] = None,
             model=wide_deep) -> TrainJob:
    """The TrainJob of the example, from ``env`` (default: the process
    environment). ``model`` is a CTR model module with wide_deep's
    interface (``models.deepfm`` for ``train_deepfm.py``)."""
    env = os.environ if env is None else env
    batch = int(env.get("TPUJOB_BATCH") or 512)
    return TrainJob(
        init_params=lambda gen: model.init(gen),
        loss_fn=model.loss_fn,
        optimizer=optim.adamw(1e-3),
        make_batch=lambda gen, step: model.synthetic_batch(gen, batch),
        total_steps=int(env.get("TPUJOB_STEPS") or 100),
        steps_per_call=int(env.get("TPUJOB_STEPS_PER_CALL") or 1),
    )


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    out = run_training(make_job())
    print("final loss:", out.get("loss"))


if __name__ == "__main__":
    main()
