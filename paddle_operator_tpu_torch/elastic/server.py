"""Embedded membership server: HTTP JSON KV with watch-by-poll revisions.

The port's copy of ``paddle_operator_tpu/elastic/server.py``: the
self-hosted replacement for the etcd Deployment the reference ships
(reference: ``deploy/elastic/etcd.yaml``). Runs standalone
(``python -m paddle_operator_tpu_torch.elastic.server --port 2379``) or
embedded in tests and ``chip_smoke.py``. Keys are namespaced per job:
``/tpujob/{ns}-{name}/np`` etc.
"""

from __future__ import annotations

import argparse
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .store import MemoryKVStore


class _Handler(BaseHTTPRequestHandler):
    store: MemoryKVStore = None  # injected

    def _send(self, code: int, body: dict) -> None:
        payload = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, fmt, *args):  # quiet
        pass

    def _params(self) -> dict:
        qs = urllib.parse.urlparse(self.path).query
        return {k: v[0] for k, v in urllib.parse.parse_qs(qs).items()}

    def do_GET(self):
        path = urllib.parse.urlparse(self.path).path
        if path == "/healthz":
            return self._send(200, {"ok": True})
        if path != "/v1/kv":
            return self._send(404, {"error": "not found"})
        p = self._params()
        if "prefix" in p:
            return self._send(
                200,
                {"kvs": self.store.list_prefix(p["prefix"]),
                 "revision": self.store.revision},
            )
        value = self.store.get(p.get("key", ""))
        if value is None:
            return self._send(404, {"error": "key not found"})
        return self._send(200, {"key": p["key"], "value": value,
                                "revision": self.store.revision})

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(length) or b"{}")
        if "key" not in body:
            return self._send(400, {"error": "key required"})
        self.store.put(body["key"], str(body.get("value", "")))
        return self._send(200, {"revision": self.store.revision})

    def do_DELETE(self):
        p = self._params()
        if self.store.get(p.get("key", "")) is None:
            return self._send(404, {"error": "key not found"})
        self.store.delete(p["key"])
        return self._send(200, {"revision": self.store.revision})


class MembershipServer:
    """Embeddable server; use as context manager in tests."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self.store = MemoryKVStore()
        handler = type("BoundHandler", (_Handler,), {"store": self.store})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def endpoint(self) -> str:
        host, port = self._httpd.server_address[:2]
        return "http://%s:%d" % (host, port)

    def start(self) -> "MembershipServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="elastic-kv")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def main(argv=None):
    ap = argparse.ArgumentParser(description="tpujob elastic membership server")
    ap.add_argument("--port", type=int, default=2379)
    ap.add_argument("--host", default="0.0.0.0")
    args = ap.parse_args(argv)
    srv = MembershipServer(port=args.port, host=args.host)
    print("membership server listening on %s" % srv.endpoint, flush=True)
    try:
        srv._httpd.serve_forever()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
