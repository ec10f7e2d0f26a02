"""Layers (:mod:`.nn`) and kernels (:mod:`.attention`) of the port."""
