"""PyTorch/CUDA port of the paddle_operator_tpu runtime, for an NVIDIA
H100 (Hopper, sm_90a).

The JAX package ``paddle_operator_tpu`` stays the reference; this package
imports ``torch`` and nothing of it. Every Pallas kernel on a ported path
has a hand-written CUDA counterpart under ``csrc/``, built with ``nvcc``
at first use (:mod:`.ops._kernels`), never at import.

Ported so far:

* the serving path (:mod:`.serving`): continuous batching over GPT
  (:mod:`.models.gpt`) with a paged KV cache and the paged
  decode-attention kernel (:mod:`.ops.attention`);
* training (:mod:`.runner`): ResNet (:mod:`.models.resnet`), GPT and
  BERT through the train step (:mod:`.parallel.train`), the input
  pipeline (:mod:`.data`) and checkpoints (:mod:`.utils.checkpoint`),
  updated by SGD, ``fused_sgd``'s multi-tensor kernel or AdamW
  (:mod:`.ops.optim`); on one device, or data-parallel over the worker
  processes that :mod:`.launch` joins into a ``dp`` mesh
  (:mod:`.parallel.mesh`, :mod:`.parallel.collectives`), or a ``dp`` x
  ``sp`` mesh with ring attention (:mod:`.parallel.context`);
* the CTR models (:mod:`.models.wide_deep`, :mod:`.models.deepfm`), in
  collective mode through the runner and in parameter-server mode
  (:mod:`.ps`): numpy pservers on the host, BSP trainers on the card.

Entry points run on CUDA unless given ``device="cpu"``
(:func:`.device.resolve_device`).
"""
