"""The train step (:mod:`.train`), on one device or over a mesh of
processes (:mod:`.mesh`, :mod:`.collectives`), the reference's sharding
rule tables (:mod:`.sharding`) and GPipe over a ``pp`` axis
(:mod:`.pipeline`)."""

from .pipeline import (  # noqa: F401
    pipeline_apply, shard_stacked_params, stack_stage_params,
)
from .sharding import (  # noqa: F401
    bert_rules, ctr_rules, gpt_rules, moe_rules, named, resnet_rules,
    shard_tree,
)
from .train import build_train_step  # noqa: F401

__all__ = ["build_train_step", "shard_tree", "named", "bert_rules",
           "gpt_rules", "moe_rules", "resnet_rules", "ctr_rules",
           "pipeline_apply", "stack_stage_params", "shard_stacked_params"]
