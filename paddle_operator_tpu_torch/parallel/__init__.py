"""The train step (:mod:`.train`), on one device or over a mesh of
processes (:mod:`.mesh`, :mod:`.collectives`), and the reference's
sharding rule tables (:mod:`.sharding`)."""

from .sharding import (  # noqa: F401
    bert_rules, ctr_rules, gpt_rules, moe_rules, named, resnet_rules,
    shard_tree,
)
from .train import build_train_step  # noqa: F401

__all__ = ["build_train_step", "shard_tree", "named", "bert_rules",
           "gpt_rules", "moe_rules", "resnet_rules", "ctr_rules"]
