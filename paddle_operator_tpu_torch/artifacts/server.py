"""ArtifactServer: the operator-served HTTP tier of the artifact store,
the port's copy of ``paddle_operator_tpu/artifacts/server.py``.

An embedded ``ThreadingHTTPServer``, like the membership server
(:mod:`..elastic.server`): standalone
(``python -m paddle_operator_tpu_torch.artifacts.server --port 8083``) or
embedded in tests and ``chip_smoke.py``.

Endpoints (JSON except the bundle bodies):

* ``GET  /healthz``: liveness.
* ``GET  /v1/artifact?fp=F[&member=M]``: the verified bundle for
  fingerprint F (``application/octet-stream``), or one member of it
  re-packed alone; 404 on a miss.
* ``PUT  /v1/artifact?fp=F``: publish a bundle. The server VERIFIES the
  envelope (CRC + fingerprint) before accepting: a poisoned publish is
  answered 400 and counted, and never reaches a peer. Members MERGE into
  an existing bundle with the atomic tmp + replace discipline. A body
  over ``MAX_BUNDLE_BYTES`` is refused with 400.
* ``POST /v1/lease`` ``{"fp","holder","ttl"}``: compile-lease acquire,
  at most one live holder per fingerprint; an expired lease goes to the
  next acquirer (a dead leaseholder costs its TTL, never a wedge), and a
  re-acquire by the same holder refreshes the deadline.
* ``GET  /v1/lease?fp=F``: ``{"fp": F, "state": "held"|"free"}``.
* ``DELETE /v1/lease?fp=F&holder=H``: release (holder-checked).

The wire is the reference's: the same JSON bodies and codes. The lease
table and the request counters live in :class:`_ServerState` under one
lock.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from ..obs.exposition import http_respond
from . import bundle
from .bundle import PoisonedArtifactError

log = logging.getLogger("tpujob.artifacts.server")

_OPS = ("fetch_hit", "fetch_miss", "publish", "publish_rejected",
        "poisoned_quarantined", "lease_grant", "lease_deny",
        "lease_release")


class _ServerState:
    """The lease table and the request counters, under one lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # fingerprint -> (holder, monotonic deadline)
        self.leases: Dict[str, Tuple[str, float]] = {}
        self.counts: Dict[str, int] = {op: 0 for op in _OPS}

    def bump(self, op: str) -> None:
        with self._lock:
            self.counts[op] = self.counts.get(op, 0) + 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)

    def lease_acquire(self, fp: str, holder: str,
                      ttl: float) -> Tuple[bool, bool]:
        """(granted, broke): ``broke`` marks an expired lease of a DEAD
        holder being taken over, told to the client so that the
        ``broken`` outcome counts on the remote tier too."""
        now = time.monotonic()
        with self._lock:
            cur = self.leases.get(fp)
            if cur is not None and cur[1] > now and cur[0] != holder:
                return False, False
            broke = cur is not None and cur[1] <= now and cur[0] != holder
            self.leases[fp] = (holder, now + max(1.0, ttl))
            return True, broke

    def lease_state(self, fp: str) -> str:
        now = time.monotonic()
        with self._lock:
            cur = self.leases.get(fp)
            if cur is None or cur[1] <= now:
                return "free"
            return "held"

    def lease_release(self, fp: str, holder: str) -> bool:
        with self._lock:
            cur = self.leases.get(fp)
            if cur is not None and cur[0] == holder:
                del self.leases[fp]
                return True
            return False

    def leases_held(self) -> int:
        """Leases whose deadline has not passed."""
        now = time.monotonic()
        with self._lock:
            return sum(1 for _, deadline in self.leases.values()
                       if deadline > now)


class _Handler(BaseHTTPRequestHandler):
    server_ref: Optional["ArtifactServer"] = None  # injected via type()

    def log_message(self, fmt: str, *args: Any) -> None:  # quiet
        pass

    def _params(self) -> dict:
        qs = urllib.parse.urlparse(self.path).query
        return {k: v[0] for k, v in urllib.parse.parse_qs(qs).items()}

    def _json(self, code: int, body: dict) -> None:
        http_respond(self, code, json.dumps(body).encode(),
                     ctype="application/json")

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        path = urllib.parse.urlparse(self.path).path
        srv = self.server_ref
        if path == "/healthz":
            return self._json(200, {"ok": True})
        if path == "/v1/artifact":
            p = self._params()
            fp = p.get("fp", "")
            member = p.get("member", "")
            data = srv.read_bundle(fp)
            if data is not None and member:
                # member-scoped fetch: re-pack just the asked-for member
                members = bundle.parse(data, fp)  # read_bundle verified
                data = (bundle.pack(fp, {member: members[member]})
                        if member in members else None)
            if data is None:
                srv.state.bump("fetch_miss")
                return self._json(404, {"error": "artifact not found"})
            srv.state.bump("fetch_hit")
            return http_respond(self, 200, data,
                                ctype="application/octet-stream")
        if path == "/v1/lease":
            fp = self._params().get("fp", "")
            return self._json(200, {"fp": fp,
                                    "state": srv.state.lease_state(fp)})
        return self._json(404, {"error": "not found"})

    def do_PUT(self) -> None:  # noqa: N802
        path = urllib.parse.urlparse(self.path).path
        srv = self.server_ref
        if path != "/v1/artifact":
            return self._json(404, {"error": "not found"})
        fp = self._params().get("fp", "")
        try:
            length = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            length = -1  # a malformed header answers 400, not a traceback
        if length <= 0 or length > bundle.MAX_BUNDLE_BYTES:
            srv.state.bump("publish_rejected")
            return self._json(400, {"error": "bad content length"})
        data = self.rfile.read(length)
        try:
            members = srv.accept_publish(fp, data)
        except PoisonedArtifactError as e:
            srv.state.bump("publish_rejected")
            return self._json(400, {"error": "rejected: %s" % e})
        except OSError as e:
            # full or read-only disk: the publisher loses nothing but the
            # share; answer, do not kill the handler thread
            log.warning("artifact publish for %s failed on disk: %s",
                        fp[:12], e)
            srv.state.bump("publish_rejected")
            return self._json(500, {"error": "store unwritable"})
        srv.state.bump("publish")
        return self._json(200, {"fp": fp, "members": members})

    def do_POST(self) -> None:  # noqa: N802
        path = urllib.parse.urlparse(self.path).path
        srv = self.server_ref
        if path != "/v1/lease":
            return self._json(404, {"error": "not found"})
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(max(0, length)) or b"{}")
            fp, holder = body["fp"], body["holder"]
            ttl = float(body.get("ttl", 300.0))
        except (ValueError, KeyError, TypeError):
            return self._json(400, {"error": "fp and holder required"})
        granted, broke = srv.state.lease_acquire(fp, holder, ttl)
        srv.state.bump("lease_grant" if granted else "lease_deny")
        return self._json(200, {"granted": granted, "broke": broke,
                                "fp": fp})

    def do_DELETE(self) -> None:  # noqa: N802
        path = urllib.parse.urlparse(self.path).path
        srv = self.server_ref
        if path != "/v1/lease":
            return self._json(404, {"error": "not found"})
        p = self._params()
        released = srv.state.lease_release(p.get("fp", ""),
                                           p.get("holder", ""))
        srv.state.bump("lease_release")
        return self._json(200, {"released": released})


class ArtifactServer:
    """Embeddable server over a local bundle directory; a context
    manager like :class:`..elastic.server.MembershipServer`."""

    def __init__(self, bind: str = ":0", store_dir: str = "") -> None:
        host, _, port = bind.rpartition(":")
        # ':8083' means all interfaces, like every other server bind of
        # the operator: a loopback default would serve the tier to nobody
        host = host or "0.0.0.0"
        self.store_dir = store_dir
        self.state = _ServerState()
        # serializes read-merge-replace publishes (file IO stays out of
        # the counters' lock)
        self._merge_lock = threading.Lock()
        handler = type("BoundArtifactHandler", (_Handler,),
                       {"server_ref": self})
        self._httpd = ThreadingHTTPServer((host, int(port)), handler)
        self._thread: Optional[threading.Thread] = None

    # -- bundle storage (the server IS a local tier) ---------------------

    def _path(self, fp: str) -> Optional[str]:
        # fingerprints are hex digests; refuse anything path-shaped
        if not fp or not all(c in "0123456789abcdef" for c in fp):
            return None
        return os.path.join(self.store_dir, fp + bundle.SUFFIX)

    def read_bundle(self, fp: str) -> Optional[bytes]:
        """Raw VERIFIED bundle bytes, or None. A poisoned file on the
        server's own disk is deleted, counted as ``poisoned_quarantined``
        and served as a miss: the store heals at the next publish."""
        path = self._path(fp)
        if path is None:
            return None
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError:
            return None
        try:
            bundle.parse(data, fp)
        except PoisonedArtifactError as e:
            log.warning("quarantining poisoned stored artifact %s: %s",
                        fp[:12], e)
            self.state.bump("poisoned_quarantined")
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        return data

    def accept_publish(self, fp: str, data: bytes) -> int:
        """Verify + merge one published bundle; returns the merged member
        count. Raises PoisonedArtifactError on a bad envelope."""
        members = bundle.parse(data, fp)
        path = self._path(fp)
        if path is None:
            raise PoisonedArtifactError("malformed fingerprint %r" % fp)
        with self._merge_lock:
            return bundle.merge_write(path, fp, members)

    # -- lifecycle -------------------------------------------------------

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return "http://%s:%d" % (host, port)

    def start(self) -> "ArtifactServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="artifact-store")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def __enter__(self) -> "ArtifactServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- observability ---------------------------------------------------

    def metrics_text(self) -> str:
        """The served tier's exposition."""
        counts = self.state.snapshot()
        lines = [
            "# HELP tpujob_artifact_server_requests_total artifact-store "
            "server operations (fetch/publish/lease), by op",
            "# TYPE tpujob_artifact_server_requests_total counter",
        ]
        lines += ['tpujob_artifact_server_requests_total{op="%s"} %d'
                  % (op, counts.get(op, 0)) for op in _OPS]
        return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="tpujob fleet compile-artifact store server")
    ap.add_argument("--port", type=int, default=8083)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--store-dir", default="",
                    help="bundle directory (default: "
                         "$TPUJOB_ARTIFACT_STORE or ~/.cache/tpujob/"
                         "artifacts)")
    args = ap.parse_args(argv)
    store_dir = args.store_dir or os.environ.get(
        "TPUJOB_ARTIFACT_STORE", "") or os.path.expanduser(
        "~/.cache/tpujob/artifacts")
    srv = ArtifactServer("%s:%d" % (args.host, args.port),
                         store_dir=store_dir)
    srv.start()
    print("artifact store serving %s at %s" % (store_dir, srv.url),
          flush=True)
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
