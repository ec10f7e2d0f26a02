"""Checkpoint-state bundles: the artifact tier MOVEs a job, the port's
copy of ``paddle_operator_tpu/artifacts/state.py``.

Live migration needs the source's final drain checkpoint to reach the
destination host through the artifact store's HTTP tier, CRC-pinned and
verify-not-trust, with no shared-filesystem round trip. This module
carries checkpoint step directories in the ``.tpuart`` envelope
(:mod:`.bundle`):

* :func:`state_fingerprint`: the key a state streams under. A KEY (job
  identity + step), not a content hash: source and destination agree on
  it before the destination has a single byte. Content integrity rides
  the envelope (per-member CRCs) and the checkpoint's own manifest
  commit marker, so a poisoned or torn transfer is rejected at the
  destination and the job falls back to its last durable checkpoint; it
  can never restore wrong state.
* :func:`publish_state`: pack one committed ``step_*`` directory
  (``state.npz`` + ``manifest.json``, or the sharded layout) into
  members keyed by file name, plus a :data:`MANIFEST_MEMBER` listing,
  and publish through every configured tier.
* :func:`fetch_state`: the destination's side: a member-scoped GET for
  the listing, then each member on its own, assembled into the
  destination's checkpoint dir under a ``.prestage_`` temporary name and
  renamed into place, so a restore never sees a half-fetched step
  (``utils.checkpoint`` lists only ``step_`` names).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Dict, Optional

from .store import ArtifactStore

#: the shard-listing member of a state bundle (the leading underscore
#: keeps it out of any file name a checkpoint writer could produce)
MANIFEST_MEMBER = "_state_manifest"

#: the step-directory spelling of ``utils.checkpoint``, kept literal here
#: so that this package stays importable without it
STEP_DIR_FMT = "step_%012d"


def state_fingerprint(namespace: str, name: str, step: int) -> str:
    """The store key of one job's state at one step. Pure hex (the
    server's path guard admits nothing else); the ``state:`` domain
    prefix inside the hash keeps state keys apart from compile
    fingerprints in the shared namespace."""
    return hashlib.sha256(
        ("state:%s/%s:%d" % (namespace, name, int(step))).encode()
    ).hexdigest()[:40]


def pack_state_dir(step_dir: str) -> Optional[Dict[str, bytes]]:
    """Members for one committed checkpoint step directory: every regular
    file keyed by its file name, plus the listing. None when the
    directory is missing or empty (nothing to pre-stage)."""
    try:
        names = sorted(os.listdir(step_dir))
    except OSError:
        return None
    members: Dict[str, bytes] = {}
    for fname in names:
        path = os.path.join(step_dir, fname)
        if not os.path.isfile(path):
            continue
        with open(path, "rb") as fh:
            members[fname] = fh.read()
    if not members:
        return None
    listing = {"files": sorted(members),
               "bytes": sum(len(v) for v in members.values())}
    members[MANIFEST_MEMBER] = json.dumps(
        listing, sort_keys=True).encode()
    return members


def publish_state(store: ArtifactStore, namespace: str, name: str,
                  step: int, ckpt_dir: str) -> Optional[str]:
    """Pre-stage one committed step: pack ``ckpt_dir/step_<step>`` and
    publish it under the state fingerprint through every configured
    tier. Returns the fingerprint, or None when the step directory is
    not there to pack. As in the reference, a tier that refuses the
    bundle (over ``MAX_BUNDLE_BYTES``, 512 MiB) still returns the
    fingerprint: the destination's pre-stage then misses and falls
    back."""
    step_dir = os.path.join(ckpt_dir, STEP_DIR_FMT % int(step))
    members = pack_state_dir(step_dir)
    if members is None:
        return None
    fp = state_fingerprint(namespace, name, step)
    store.publish(fp, members)
    return fp


def fetch_state(store: ArtifactStore, fingerprint: str, ckpt_dir: str,
                step: int) -> Optional[str]:
    """The destination's assembly: fetch the listing, then each member,
    into ``ckpt_dir/step_<step>``. Every member fetch is verified by the
    store; any miss or poisoned member aborts the WHOLE assembly (the
    temporary dir is removed and None returned), so the restore can only
    see a complete, verified step or nothing. Returns the final step
    directory on success."""
    got, _tier = store.fetch(fingerprint, member=MANIFEST_MEMBER)
    if got is None:
        return None
    try:
        listing = json.loads(got[MANIFEST_MEMBER].decode())
        files = list(listing["files"])
    except (ValueError, KeyError, TypeError):
        return None
    final = os.path.join(ckpt_dir, STEP_DIR_FMT % int(step))
    if os.path.isdir(final):
        return final  # already assembled (idempotent re-fetch)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".prestage_")
    try:
        for fname in files:
            if fname == MANIFEST_MEMBER or os.path.basename(
                    fname) != fname:
                return None  # the listing names outside the step dir
            shard, _tier = store.fetch(fingerprint, member=fname)
            if shard is None:
                return None  # miss or poison: never a partial restore
            with open(os.path.join(tmp, fname), "wb") as fh:
                fh.write(shard[fname])
        os.rename(tmp, final)
        tmp = None
        return final
    except OSError:
        return None
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


__all__ = [
    "MANIFEST_MEMBER", "STEP_DIR_FMT", "fetch_state", "pack_state_dir",
    "publish_state", "state_fingerprint",
]
