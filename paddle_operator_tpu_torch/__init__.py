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
* single-device training (:mod:`.runner`): ResNet (:mod:`.models.resnet`)
  through the train step (:mod:`.parallel.train`), the input pipeline
  (:mod:`.data`) and v2 checkpoints (:mod:`.utils.checkpoint`), updated by
  SGD or by ``fused_sgd``'s multi-tensor kernel (:mod:`.ops.optim`).

Entry points run on CUDA unless given ``device="cpu"``
(:func:`.device.resolve_device`).
"""
