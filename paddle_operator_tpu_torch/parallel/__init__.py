"""The train step (:mod:`.train`), on one device or data-parallel over
a ``dp`` mesh of processes (:mod:`.mesh`, :mod:`.collectives`)."""

from .train import build_train_step  # noqa: F401

__all__ = ["build_train_step"]
