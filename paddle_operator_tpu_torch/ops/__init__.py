"""Layers (:mod:`.nn`), optimizers (:mod:`.optim`) and kernels
(:mod:`.attention`, :func:`.optim.multi_tensor_sgd`) of the port."""
