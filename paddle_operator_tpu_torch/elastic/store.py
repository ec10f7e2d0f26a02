"""KV store interface + backends for elastic membership: the port's copy
of ``paddle_operator_tpu/elastic/store.py`` (pure Python)."""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Tuple


class KVStore:
    """The minimal slice of etcd semantics the elastic protocol needs."""

    def get(self, key: str) -> Optional[str]:
        raise NotImplementedError

    def put(self, key: str, value: str) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list_prefix(self, prefix: str) -> Dict[str, str]:
        raise NotImplementedError

    def endpoints(self) -> List[str]:
        """Endpoint list injected into pods (PADDLE_ELASTIC_SERVER analog)."""
        return []

    def compare_and_put(self, key: str, value: str) -> bool:
        """Put only if current value differs; True if written."""
        if self.get(key) == value:
            return False
        self.put(key, value)
        return True


class MemoryKVStore(KVStore):
    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[str, str] = {}
        self._revision = 0

    def get(self, key):
        with self._lock:
            return self._data.get(key)

    def put(self, key, value):
        with self._lock:
            self._data[key] = value
            self._revision += 1

    def delete(self, key):
        with self._lock:
            self._data.pop(key, None)
            self._revision += 1

    def list_prefix(self, prefix):
        with self._lock:
            return {k: v for k, v in self._data.items() if k.startswith(prefix)}

    @property
    def revision(self) -> int:
        # under the lock like every other _revision access (opslint
        # OPS101: a torn read here could skip an elastic resync epoch)
        with self._lock:
            return self._revision


class HttpKVStore(KVStore):
    """Client for the HTTP JSON KV protocol of :mod:`.server`.

    Endpoints: GET /v1/kv?key=K · GET /v1/kv?prefix=P · PUT /v1/kv (json
    {key, value}) · DELETE /v1/kv?key=K.
    """

    def __init__(self, endpoint: str, timeout: float = 3.0):
        self._endpoint = endpoint.rstrip("/")
        self._timeout = timeout

    def endpoints(self):
        return [self._endpoint]

    def _url(self, **params) -> str:
        return self._endpoint + "/v1/kv?" + urllib.parse.urlencode(params)

    def get(self, key):
        req = urllib.request.Request(self._url(key=key))
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as resp:
                body = json.loads(resp.read())
                return body.get("value")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def put(self, key, value):
        data = json.dumps({"key": key, "value": value}).encode()
        req = urllib.request.Request(
            self._endpoint + "/v1/kv", data=data, method="PUT",
            headers={"Content-Type": "application/json"},
        )
        urllib.request.urlopen(req, timeout=self._timeout).read()

    def delete(self, key):
        req = urllib.request.Request(self._url(key=key), method="DELETE")
        try:
            urllib.request.urlopen(req, timeout=self._timeout).read()
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise

    def list_prefix(self, prefix):
        req = urllib.request.Request(self._url(prefix=prefix))
        with urllib.request.urlopen(req, timeout=self._timeout) as resp:
            return json.loads(resp.read()).get("kvs", {})


def connect(endpoint: str) -> KVStore:
    """Create a store client from an endpoint string."""
    if endpoint.startswith("http://") or endpoint.startswith("https://"):
        return HttpKVStore(endpoint)
    # bare host:port — assume our HTTP protocol
    return HttpKVStore("http://" + endpoint)
