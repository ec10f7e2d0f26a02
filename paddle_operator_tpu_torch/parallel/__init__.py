"""The single-device train step of the port: :mod:`.train`."""

from .train import build_train_step  # noqa: F401

__all__ = ["build_train_step"]
