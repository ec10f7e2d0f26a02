"""The artifact envelope: fingerprint-addressed, CRC-pinned bundles, the
port's copy of ``paddle_operator_tpu/artifacts/bundle.py``. The bytes on
the wire and on disk are the reference's, byte for byte, so the port's
client and server talk to the operator's.

    b"TPUART1\\n"
    4-byte big-endian header length
    header JSON: {"fingerprint": ..., "members": [{"name", "size",
                  "crc32"}, ...]}
    member payloads, concatenated in header order

**Verify-not-trust**: a reader checks the magic, the header's
fingerprint against the one it ASKED for (a stale or renamed object must
not satisfy a different key), every member's size against the file, and
every member's CRC32 against its payload; any mismatch raises
:class:`PoisonedArtifactError` and the caller falls back (for a state
bundle: to the durable checkpoint), never to a wrong answer. CRC is an
integrity check, not an authenticity one: the store directory and the
operator's endpoint are a trust boundary.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, List

MAGIC = b"TPUART1\n"

#: refuse absurd bundles outright (a torn length field must not make a
#: reader try to allocate gigabytes)
MAX_BUNDLE_BYTES = 512 * 1024 * 1024
MAX_HEADER_BYTES = 4 * 1024 * 1024

#: the on-disk name of a fingerprint's bundle in a local-tier directory
SUFFIX = ".tpuart"


class PoisonedArtifactError(ValueError):
    """A fetched artifact failed verification (torn file, flipped bytes,
    stale fingerprint). Always handled as reject-and-fall-back."""


def pack(fingerprint: str, members: Dict[str, bytes]) -> bytes:
    """Serialize ``members`` (name -> payload bytes) into one envelope."""
    order: List[str] = sorted(members)
    header = {
        "fingerprint": fingerprint,
        "members": [{"name": n, "size": len(members[n]),
                     "crc32": zlib.crc32(members[n]) & 0xFFFFFFFF}
                    for n in order],
    }
    head = json.dumps(header, sort_keys=True).encode()
    out = [MAGIC, struct.pack(">I", len(head)), head]
    out.extend(members[n] for n in order)
    return b"".join(out)


def parse(data: bytes, expect_fingerprint: str) -> Dict[str, bytes]:
    """Parse + verify an envelope. Raises :class:`PoisonedArtifactError`
    on ANY mismatch; returns member name -> payload bytes."""
    if len(data) > MAX_BUNDLE_BYTES:
        raise PoisonedArtifactError("bundle exceeds %d bytes"
                                    % MAX_BUNDLE_BYTES)
    if not data.startswith(MAGIC):
        raise PoisonedArtifactError("bad magic")
    off = len(MAGIC)
    if len(data) < off + 4:
        raise PoisonedArtifactError("torn header length")
    (hlen,) = struct.unpack(">I", data[off:off + 4])
    off += 4
    if hlen > MAX_HEADER_BYTES or len(data) < off + hlen:
        raise PoisonedArtifactError("torn header")
    try:
        header = json.loads(data[off:off + hlen])
    except ValueError as e:
        raise PoisonedArtifactError("corrupt header json: %s" % e)
    off += hlen
    if not isinstance(header, dict) or \
            not isinstance(header.get("members"), list):
        raise PoisonedArtifactError("malformed header")
    if header.get("fingerprint") != expect_fingerprint:
        # the stale-fingerprint case: a renamed/mis-served object must
        # never satisfy a different key
        raise PoisonedArtifactError(
            "fingerprint mismatch: bundle says %r, caller asked for %r"
            % (header.get("fingerprint"), expect_fingerprint))
    members: Dict[str, bytes] = {}
    for m in header["members"]:
        try:
            name, size, crc = m["name"], int(m["size"]), int(m["crc32"])
        except (TypeError, KeyError, ValueError) as e:
            raise PoisonedArtifactError("malformed member entry: %s" % e)
        if not isinstance(name, str) or size < 0:
            raise PoisonedArtifactError("malformed member entry")
        payload = data[off:off + size]
        if len(payload) != size:
            raise PoisonedArtifactError("torn payload for member %r" % name)
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise PoisonedArtifactError("crc mismatch on member %r" % name)
        members[name] = payload
        off += size
    if off != len(data):
        raise PoisonedArtifactError("%d trailing bytes after last member"
                                    % (len(data) - off))
    return members


def merge_write(path: str, fingerprint: str,
                members: Dict[str, bytes]) -> int:
    """Merge ``members`` over any existing bundle at ``path`` (new
    payloads win, absent old members are preserved) and atomically
    replace (tmp + ``os.replace``). The one merge implementation both
    the client's local tier and the server share. Returns the merged
    member count; raises OSError on an unwritable target (callers pick
    their own degradation); an existing poisoned bundle is simply
    replaced."""
    merged = dict(members)
    try:
        with open(path, "rb") as fh:
            old = parse(fh.read(), fingerprint)
        for name, payload in old.items():
            merged.setdefault(name, payload)
    except (OSError, PoisonedArtifactError):
        pass
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    try:
        with open(tmp, "wb") as fh:
            fh.write(pack(fingerprint, merged))
        os.replace(tmp, path)
    except BaseException:
        # cleanup covers every raiser, not just OSError: a pack() failure
        # mid-write would otherwise strand the torn tmp
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return len(merged)
