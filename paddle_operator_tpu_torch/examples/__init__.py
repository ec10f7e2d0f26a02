"""Entry points of the port, run as ``python -m
paddle_operator_tpu_torch.examples.<name>``."""
