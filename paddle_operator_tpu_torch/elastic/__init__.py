"""Elastic membership: the etcd-equivalent KV store and the sync
protocol, the port's own copies of ``paddle_operator_tpu/elastic/``'s
pure-Python parts.

The operator publishes the desired world size ("np") to the key
``/tpujob/{ns}-{name}/np`` and bumps a membership *epoch* beside it; the
in-pod agent (:class:`..launch.ElasticAgent`) watches the epoch and the
runner re-forms the ``torch.distributed`` world at the new ``np`` and
resumes from the newest checkpoint. Three backends of the KV interface:
an in-memory store (tests), and an HTTP JSON store served by
:mod:`.server` (self-hosted, no etcd dependency) with its client.
"""

from .store import HttpKVStore, KVStore, MemoryKVStore  # noqa: F401
from .sync import JobRef, bump_epoch, epoch_key, np_key  # noqa: F401
