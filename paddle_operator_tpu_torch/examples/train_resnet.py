"""ResNet-50 training entry of the port, on one CUDA device or one a
worker:

    python -m paddle_operator_tpu_torch.examples.train_resnet
    python -m paddle_operator_tpu_torch.launch \
        paddle_operator_tpu_torch/examples/train_resnet.py   # in a pod

The counterpart of ``examples/train_resnet.py``: the same env vars
(``TPUJOB_BATCH``, the global batch over every worker, ``TPUJOB_STEPS``,
``TPUJOB_STEPS_PER_CALL``, ``TPUJOB_CHECKPOINT_DIR``), plain ``sgd`` with
momentum 0.9, weight decay 1e-4 and ``cosine_schedule(0.4, STEPS, STEPS
// 20)``, synthetic batches, bf16 compute on fp32 master parameters.
``optim.fused_sgd`` is the drop-in that runs the update as one CUDA
kernel launch per step. Under ``launch`` with several workers
``run_training`` splits the batch over a ``dp`` mesh. The job carries the
reference's ``resnet_rules()``: on a mesh with an ``fsdp`` axis (a
caller's ``mesh_axes``, e.g. ``{"dp": 2, "fsdp": 2}``) each worker holds
its columns of the classifier; a dp mesh lacks fsdp and drops them.
"""

import logging
import os

from paddle_operator_tpu_torch.models import resnet
from paddle_operator_tpu_torch.ops import optim
from paddle_operator_tpu_torch.parallel import sharding
from paddle_operator_tpu_torch.runner import TrainJob, run_training

BATCH = int(os.environ.get("TPUJOB_BATCH", "128"))
STEPS = int(os.environ.get("TPUJOB_STEPS", "200"))
# >1 runs K optimizer steps per step_fn call on a [K, ...] window
STEPS_PER_CALL = int(os.environ.get("TPUJOB_STEPS_PER_CALL", "1"))


def make_job() -> TrainJob:
    return TrainJob(
        init_params=lambda gen: resnet.init(gen, depth=50, num_classes=1000),
        loss_fn=resnet.loss_fn,
        optimizer=optim.sgd(
            optim.cosine_schedule(0.4, STEPS, STEPS // 20),
            momentum=0.9, weight_decay=1e-4,
        ),
        make_batch=lambda gen, step: resnet.synthetic_batch(gen, BATCH),
        merge_stats=resnet.merge_stats,
        total_steps=STEPS,
        steps_per_call=STEPS_PER_CALL,
        checkpoint_dir=os.environ.get("TPUJOB_CHECKPOINT_DIR", ""),
        rules=sharding.resnet_rules(),
    )


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    out = run_training(make_job())
    print("final loss:", out.get("loss"))


if __name__ == "__main__":
    main()
