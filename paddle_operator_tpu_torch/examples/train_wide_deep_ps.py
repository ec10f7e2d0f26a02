"""wide_and_deep CTR training in PS mode, the port's counterpart of
``examples/train_wide_deep_ps.py``.

Every pod of a PS world the operator rendered runs this same script
directly (not through ``python -m paddle_operator_tpu_torch.launch``,
which would join the trainers into a ``torch.distributed`` group they do
not use)::

    python paddle_operator_tpu_torch/examples/train_wide_deep_ps.py

``TRAINING_ROLE`` decides the role (:func:`..launch.detect_env`):
``PSERVER`` serves shard ``PADDLE_TRAINER_ID`` of
``PADDLE_PSERVERS_IP_PORT_LIST`` from numpy on the host and never touches
a card; ``TRAINER`` computes on CUDA and runs the BSP rounds of
:mod:`..ps`. The env of the reference: ``TPUJOB_BATCH`` (512),
``TPUJOB_STEPS`` (100), ``TPUJOB_LR`` (0.1) and ``TPUJOB_SPARSE``
(``1``: the embedding tables stay row-sharded on the pservers, and a
trainer pulls and pushes only the rows its batch touches). The
collective-mode twin is ``train_wide_deep.py``.
"""

import logging
import os
from typing import Mapping, Optional

from paddle_operator_tpu_torch import launch, ps
from paddle_operator_tpu_torch.models import wide_deep


def make_job(env: Optional[Mapping[str, str]] = None,
             model=wide_deep) -> ps.PsTrainJob:
    """The PsTrainJob of the example, from ``env`` (default: the process
    environment). ``model`` is a CTR model module with wide_deep's
    interface (``models.deepfm`` trains against the same pservers: its
    rows have the same width)."""
    env = os.environ if env is None else env
    batch = int(env.get("TPUJOB_BATCH") or 512)
    common = dict(
        make_batch=lambda gen, step: model.synthetic_batch(gen, batch),
        total_steps=int(env.get("TPUJOB_STEPS") or 100),
        lr=float(env.get("TPUJOB_LR") or 0.1))
    if env.get("TPUJOB_SPARSE", "0") == "1":
        vocab = model.DEFAULT_CONFIG["vocab_per_slot"]
        return ps.PsTrainJob(
            init_params=lambda gen: model.init_dense(gen),
            loss_fn=model.sparse_loss_fn,
            ids_fn=lambda b: model.sparse_ids(b, vocab),
            embed_dim=model.sparse_row_dim(), **common)
    return ps.PsTrainJob(init_params=lambda gen: model.init(gen),
                         loss_fn=model.loss_fn, **common)


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    job = make_job()
    out = ps.run_ps_training(job, launch.detect_env())
    if out["role"] == "TRAINER":
        print("final loss:", out["losses"][-1])
        if job.embed_dim > 0:
            print("wire bytes: sent=%d recv=%d over %d rounds"
                  % (out["bytes_sent"], out["bytes_recv"], job.total_steps))


if __name__ == "__main__":
    main()
