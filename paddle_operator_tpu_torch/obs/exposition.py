"""The response writer of the port's stdlib HTTP handlers, the port's
copy of ``http_respond`` in ``paddle_operator_tpu/obs/exposition.py``.
The Prometheus text-format validation of that file is not ported."""

from __future__ import annotations

from typing import Any


def http_respond(req: Any, code: int, body: bytes,
                 ctype: str = "text/plain") -> None:
    """The one response writer for the port's stdlib HTTP handlers:
    headers + body, with the client-went-away errors swallowed."""
    req.send_response(code)
    req.send_header("Content-Type", ctype)
    req.send_header("Content-Length", str(len(body)))
    req.end_headers()
    try:
        req.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
        pass
