"""The elastic protocol's keys and the epoch bump: the port's copy of
``paddle_operator_tpu/elastic/sync.py``.

The controller writes the desired world size to ``np`` and bumps
``epoch`` whenever it changes (``np`` first); workers poll the epoch
(:class:`..launch.ElasticAgent`) and restart collectively from the last
checkpoint. ``sync_np`` is the controller's and is not ported; here
:func:`bump_epoch` takes any job with ``namespace`` and ``name``, such
as the :class:`JobRef` a worker reads from its job id.
"""

from __future__ import annotations

from typing import Any, NamedTuple

from .store import KVStore


class JobRef(NamedTuple):
    """The namespace and name of an elastic job, which its keys address."""

    namespace: str
    name: str

    @classmethod
    def of(cls, job_id: str) -> "JobRef":
        """From a worker's job id (``PADDLE_ELASTIC_JOB_ID``,
        ``"<namespace>-<name>"``) as the agent reads it: split at the
        first ``-``; an id without one is a name in ``default``; an empty
        id is ``default-job``."""
        ns_name = job_id or "default-job"
        if "-" in ns_name:
            ns, _, name = ns_name.partition("-")
            return cls(ns, name)
        return cls("default", ns_name)


def np_key(namespace: str, name: str) -> str:
    """Reference key shape: /paddle/{ns}-{name}/np (paddlejob_elastic.go:46)."""
    return "/tpujob/%s-%s/np" % (namespace, name)


def epoch_key(namespace: str, name: str) -> str:
    return "/tpujob/%s-%s/epoch" % (namespace, name)


def bump_epoch(store: KVStore, job: Any) -> str:
    """Advance the membership epoch of ``job`` (anything with
    ``namespace`` and ``name``): the whole-world restart signal. Workers
    polling the epoch end the current cycle at the next step boundary and
    re-enter from the latest checkpoint at the world size ``np`` then
    says. Returns the new epoch."""
    key = epoch_key(job.namespace, job.name)
    new = str(int(store.get(key) or "0") + 1)
    store.put(key, new)
    return new
