"""DeepFM CTR training entry of the port, on one CUDA device or one a
worker:

    python -m paddle_operator_tpu_torch.examples.train_deepfm
    python -m paddle_operator_tpu_torch.launch \\
        paddle_operator_tpu_torch/examples/train_deepfm.py   # in a pod

The counterpart of ``examples/train_deepfm.py``: ``train_wide_deep.py``'s
job (the same env vars, ``adamw(1e-3)``, bf16 compute on fp32 master
parameters, a dp mesh under ``launch``, ``ctr_rules`` replicated) over
``models.deepfm``.
"""

import logging
from typing import Mapping, Optional

from paddle_operator_tpu_torch.examples import train_wide_deep
from paddle_operator_tpu_torch.models import deepfm
from paddle_operator_tpu_torch.runner import TrainJob, run_training


def make_job(env: Optional[Mapping[str, str]] = None) -> TrainJob:
    """The TrainJob of the example, from ``env`` (default: the process
    environment)."""
    return train_wide_deep.make_job(env, model=deepfm)


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    out = run_training(make_job())
    print("final loss:", out.get("loss"))


if __name__ == "__main__":
    main()
