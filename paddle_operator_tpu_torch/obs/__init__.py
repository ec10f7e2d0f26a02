"""Observability helpers of the port: the one HTTP response writer its
stdlib servers share (:func:`.exposition.http_respond`)."""

from .exposition import http_respond  # noqa: F401
