"""The compile-lease protocol of the port's artifact tier
(``paddle_operator_tpu_torch.artifacts``), the counterparts of the JAX
package's ``tests/test_artifacts.py::TestLeaseProtocol``: the lease file
denies across processes, a dead holder's lease is broken, ``wait_fetch``
returns when the lease dies, the remote lifecycle and TTL expiry, a
failed build releases its lease, and a cold start of threads or
processes builds once. The wire is held against the reference: the
port's client against the reference's server and the reference's client
against the port's give the same answers.

No sleep races a TTL: expiry is driven by an injected clock (the
modules' ``time`` replaced by one whose wall and monotonic clocks can be
moved forward), and real waits have margins of whole seconds.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from paddle_operator_tpu.artifacts import server as ref_server_mod
from paddle_operator_tpu.artifacts import store as ref_store_mod
from paddle_operator_tpu_torch import artifacts, compile_cache as cc
from paddle_operator_tpu_torch.artifacts import server as server_mod
from paddle_operator_tpu_torch.artifacts import store as store_mod
from paddle_operator_tpu_torch.artifacts.server import ArtifactServer
from paddle_operator_tpu_torch.artifacts.store import ArtifactStore
from paddle_operator_tpu_torch.ops import _kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP = "ab" * 16


class Clock:
    """``time`` with the wall and monotonic clocks ``offset`` seconds
    ahead; everything else is the real module's."""

    def __init__(self):
        self.offset = 0.0

    def time(self):
        return time.time() + self.offset

    def monotonic(self):
        return time.monotonic() + self.offset

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for mod in (store_mod, server_mod, ref_store_mod, ref_server_mod):
        monkeypatch.setattr(mod, "time", c)
    return c


@pytest.fixture
def lease_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "store")
    monkeypatch.setenv("TPUJOB_ARTIFACT_STORE", d)
    monkeypatch.delenv("TPUJOB_ARTIFACT_URL", raising=False)
    artifacts.reset_for_tests()
    yield d
    artifacts.reset_for_tests()


def _store(d, **kw):
    kw.setdefault("poll_s", 0.01)
    kw.setdefault("wait_s", 30.0)
    return ArtifactStore(local_dir=d, **kw)


# ---------------------------------------------------------------------------
# the local tier's lease file
# ---------------------------------------------------------------------------

def test_one_grant_per_fingerprint(lease_dir):
    s = artifacts.get_store()
    first = s.acquire_compile_lease(FP)
    assert first.granted
    assert not s.acquire_compile_lease(FP).granted
    assert s.lease_state(FP) == "held"
    first.release()
    assert s.lease_state(FP) == "free"
    again = s.acquire_compile_lease(FP)
    assert again.granted
    again.release()
    assert s.stats()["lease_granted"] == 2
    assert s.stats()["lease_waited"] == 1


def test_cross_process_lease_file_denies(lease_dir, clock):
    """A holder in another process: while its lease is live every acquire
    here is denied; once its TTL has passed (the clock moved 301 s) the
    next acquirer breaks it."""
    snippet = (
        "import sys; sys.path.insert(0, %r)\n"
        "from paddle_operator_tpu_torch.artifacts.store import "
        "ArtifactStore\n"
        "lease = ArtifactStore(local_dir=sys.argv[1], lease_ttl_s=300.0)"
        ".acquire_compile_lease(%r)\n"
        "print('granted' if lease.granted else 'denied')\n" % (REPO, FP))
    out = subprocess.run([sys.executable, "-c", snippet, lease_dir],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split()
    assert out == ["granted"]   # and the holder exited without a release
    here = _store(lease_dir)
    assert not here.acquire_compile_lease(FP).granted
    assert here.lease_state(FP) == "held"
    clock.offset = 301.0
    assert here.lease_state(FP) == "expired"
    lease = here.acquire_compile_lease(FP)
    assert lease.granted
    assert here.stats()["lease_broken"] == 1
    lease.release()
    assert not os.path.exists(os.path.join(lease_dir, FP + ".lease"))


def test_dead_leaseholder_broken_within_the_deadline(lease_dir, clock):
    dead = _store(lease_dir, lease_ttl_s=5.0)
    assert dead.acquire_compile_lease(FP).granted
    live = _store(lease_dir)
    assert not live.acquire_compile_lease(FP).granted
    clock.offset = 6.0   # past the dead holder's 5 s
    t0 = time.monotonic()
    lease = live.acquire_compile_lease(FP)
    assert lease.granted and time.monotonic() - t0 < 1.0
    assert live.stats()["lease_broken"] == 1
    lease.release()


def test_two_breakers_at_most_one_granted(lease_dir, clock):
    dead = _store(lease_dir, lease_ttl_s=5.0)
    assert dead.acquire_compile_lease(FP).granted
    clock.offset = 6.0
    stores = [_store(lease_dir) for _ in range(4)]
    grants, lock = [], threading.Lock()
    barrier = threading.Barrier(len(stores))

    def breaker(s):
        barrier.wait(timeout=30)
        lease = s.acquire_compile_lease(FP)
        if lease.granted:
            with lock:
                grants.append(lease)

    threads = [threading.Thread(target=breaker, args=(s,)) for s in stores]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(grants) == 1
    grants[0].release()


def test_wait_fetch_returns_on_publish(lease_dir):
    waiter, holder = _store(lease_dir), _store(lease_dir)
    lease = holder.acquire_compile_lease(FP)
    assert lease.granted

    def publish_later():
        time.sleep(0.05)
        holder.publish(FP, {"lib": b"so"})
        lease.release()

    t = threading.Thread(target=publish_later)
    t.start()
    try:
        members, tier = waiter.wait_fetch(FP, time.monotonic() + 30.0)
    finally:
        t.join(timeout=30)
    assert (members, tier) == ({"lib": b"so"}, "local")


def test_wait_fetch_returns_when_the_lease_dies(lease_dir, clock):
    """A holder that dies without publishing frees its waiters at its
    TTL, long before their deadline; they then acquire."""
    dead = _store(lease_dir, lease_ttl_s=5.0)
    assert dead.acquire_compile_lease(FP).granted
    waiter = _store(lease_dir)
    got = {}

    def wait():
        got["out"] = waiter.wait_fetch(FP, time.monotonic() + 60.0)

    t = threading.Thread(target=wait)
    t.start()
    time.sleep(0.05)
    assert t.is_alive()        # still waiting on the live lease
    clock.offset = 6.0         # the holder's TTL passes
    t.join(timeout=30)
    assert not t.is_alive()
    assert got["out"] == (None, None)
    assert waiter.stats()["lease_timeout"] == 0
    assert waiter.acquire_compile_lease(FP).granted


def test_wait_fetch_is_bounded_by_its_deadline(lease_dir):
    s = _store(lease_dir)
    lease = s.acquire_compile_lease(FP)
    assert lease.granted
    t0 = time.monotonic()
    assert s.wait_fetch(FP, time.monotonic() + 0.2) == (None, None)
    assert 0.2 <= time.monotonic() - t0 < 5.0
    assert s.stats()["lease_timeout"] == 1
    lease.release()


def test_a_publish_just_before_the_release_is_fetched(lease_dir):
    """A waiter that sees the lease free fetches once more before it
    re-acquires: a publish strictly precedes its release, so the fleet
    is not granted a second build of a published library."""
    holder, waiter = _store(lease_dir), _store(lease_dir)
    lease = holder.acquire_compile_lease(FP)
    real_state = waiter.lease_state

    def state_after_the_handoff(fp):
        if lease.granted and not lease._released:
            holder.publish(FP, {"lib": b"so"})
            lease.release()
        return real_state(fp)

    waiter.lease_state = state_after_the_handoff
    assert waiter.wait_fetch(FP, time.monotonic() + 30.0) == (
        {"lib": b"so"}, "local")


# ---------------------------------------------------------------------------
# the remote tier
# ---------------------------------------------------------------------------

@pytest.fixture
def served(tmp_path):
    srv = ArtifactServer("127.0.0.1:0", store_dir=str(tmp_path / "srv"))
    srv.start()
    yield srv
    srv.stop()


def test_remote_lease_lifecycle(served):
    a = ArtifactStore(url=served.url, poll_s=0.01)
    b = ArtifactStore(url=served.url, poll_s=0.01)
    la = a.acquire_compile_lease(FP)
    assert la.granted
    assert not b.acquire_compile_lease(FP).granted
    assert b.lease_state(FP) == "held"
    la.release()
    assert b.lease_state(FP) == "free"
    lb = b.acquire_compile_lease(FP)
    assert lb.granted
    lb.release()
    counts = served.state.snapshot()
    assert (counts["lease_grant"], counts["lease_deny"],
            counts["lease_release"]) == (2, 1, 2)
    assert served.state.leases_held() == 0


def test_remote_lease_ttl_expiry_counts_broken(served, clock):
    dead = ArtifactStore(url=served.url, lease_ttl_s=5.0)
    assert dead.acquire_compile_lease(FP).granted
    live = ArtifactStore(url=served.url, lease_ttl_s=300.0)
    assert live.lease_state(FP) == "held"
    clock.offset = 6.0
    assert live.lease_state(FP) == "free"
    lease = live.acquire_compile_lease(FP)
    assert lease.granted and live.stats()["lease_broken"] == 1
    lease.release()


def test_an_unreachable_lease_endpoint_builds_on(tmp_path):
    s = ArtifactStore(url="http://127.0.0.1:1", http_timeout_s=0.5,
                      http_retries=0)
    lease = s.acquire_compile_lease(FP)
    assert lease.granted        # no arbiter: never block on its absence
    lease.release()


def test_server_lease_metrics(served):
    from paddle_operator_tpu.obs import parse_exposition

    ArtifactStore(url=served.url).acquire_compile_lease(FP).release()
    text = served.metrics_text()
    assert parse_exposition(text) == []
    assert 'tpujob_artifact_server_requests_total{op="lease_grant"} 1' \
        in text
    client = store_mod.metrics_text()
    assert parse_exposition(client) == []
    assert 'tpujob_artifact_lease_total{outcome="granted"}' in client


# ---------------------------------------------------------------------------
# the wire, held against the reference
# ---------------------------------------------------------------------------

def _raw(url, method, path, body=None):
    req = urllib.request.Request(url + path, method=method,
                                 data=None if body is None
                                 else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _raw_sequence(url, clock):
    """One sequence of lease requests, as a client sends them: acquire,
    a rival's deny, state, release, a rival's grant, expiry and a broken
    grant, a foreign release, a malformed acquire."""
    out = [_raw(url, "POST", "/v1/lease", {"fp": FP, "holder": "a",
                                            "ttl": 5.0}),
           _raw(url, "POST", "/v1/lease", {"fp": FP, "holder": "b",
                                            "ttl": 5.0}),
           _raw(url, "GET", "/v1/lease?fp=%s" % FP),
           _raw(url, "DELETE", "/v1/lease?fp=%s&holder=b" % FP),
           _raw(url, "DELETE", "/v1/lease?fp=%s&holder=a" % FP),
           _raw(url, "GET", "/v1/lease?fp=%s" % FP),
           _raw(url, "POST", "/v1/lease", {"fp": FP, "holder": "b",
                                            "ttl": 0.5})]
    clock.offset += 2.0    # past b's TTL (the server's floor is 1 s)
    out += [_raw(url, "GET", "/v1/lease?fp=%s" % FP),
            _raw(url, "POST", "/v1/lease", {"fp": FP, "holder": "c",
                                             "ttl": 300.0}),
            _raw(url, "POST", "/v1/lease", {"fp": FP, "holder": "c",
                                             "ttl": 300.0}),
            _raw(url, "POST", "/v1/lease", {"holder": "d"})]
    return out


def test_the_wire_is_the_reference_s_byte_for_byte(tmp_path, clock):
    port = ArtifactServer("127.0.0.1:0", store_dir=str(tmp_path / "p"))
    ref = ref_server_mod.ArtifactServer("127.0.0.1:0",
                                        store_dir=str(tmp_path / "r"))
    with port, ref:
        got = _raw_sequence(port.url, clock)
        want = _raw_sequence(ref.url, clock)
        assert got == want
        assert port.state.snapshot() == ref.state.snapshot()


def _client_sequence(make, url, clock):
    a, b = make(url, 300.0), make(url, 5.0)
    out = []
    la = a.acquire_compile_lease(FP)
    out.append(("a", la.granted))
    out.append(("b", b.acquire_compile_lease(FP).granted))
    out.append(("state", b.lease_state(FP)))
    la.release()
    out.append(("state", b.lease_state(FP)))
    lb = b.acquire_compile_lease(FP)
    out.append(("b", lb.granted))
    clock.offset += 6.0    # b dies: its 5 s pass
    out.append(("state", a.lease_state(FP)))
    la = a.acquire_compile_lease(FP)
    out.append(("a", la.granted, a.stats()["lease_broken"]))
    la.release()
    out.append(("state", a.lease_state(FP)))
    return out


@pytest.mark.parametrize("client", ["port", "ref"])
@pytest.mark.parametrize("server", ["port", "ref"])
def test_clients_and_servers_interoperate(tmp_path, clock, client, server):
    """Each package's client against each package's server: the same
    grant, deny, state and release answers for the same sequence."""
    make = {"port": lambda url, ttl: ArtifactStore(url=url, lease_ttl_s=ttl),
            "ref": lambda url, ttl: ref_store_mod.ArtifactStore(
                url=url, lease_ttl_s=ttl)}[client]
    cls = {"port": ArtifactServer,
           "ref": ref_server_mod.ArtifactServer}[server]
    with cls("127.0.0.1:0", store_dir=str(tmp_path / "s")) as srv:
        got = _client_sequence(make, srv.url, clock)
        counts = srv.state.snapshot()
    assert got == [("a", True), ("b", False), ("state", "held"),
                   ("state", "free"), ("b", True), ("state", "free"),
                   ("a", True, 1), ("state", "free")]
    assert (counts["lease_grant"], counts["lease_deny"],
            counts["lease_release"]) == (3, 1, 2)


# ---------------------------------------------------------------------------
# the ladder's leases: a failed build, a cold start
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["local", "remote"])
def test_a_compile_failure_releases_the_lease(tmp_path, monkeypatch, served,
                                              tier):
    monkeypatch.setenv("TPUJOB_COMPILE_CACHE_DIR", str(tmp_path / "cache"))
    if tier == "local":
        monkeypatch.setenv("TPUJOB_ARTIFACT_STORE", str(tmp_path / "fleet"))
        monkeypatch.delenv("TPUJOB_ARTIFACT_URL", raising=False)
    else:
        monkeypatch.setenv("TPUJOB_ARTIFACT_STORE", "0")
        monkeypatch.setenv("TPUJOB_ARTIFACT_URL", served.url)
    cc.reset_stats_for_tests()
    artifacts.reset_for_tests()

    def refuse(name, path):
        raise _kernels.KernelBuildError("kernel build failed: planted")

    monkeypatch.setattr(_kernels, "build", refuse)
    try:
        with pytest.raises(_kernels.KernelBuildError):
            cc.load_library("fused_sgd")
        store = artifacts.get_store()
        fp = cc.library_fingerprint("fused_sgd")
        assert store.lease_state(fp) == "free"
        assert store.stats()["lease_granted"] == 1
        again = store.acquire_compile_lease(fp)
        assert again.granted
        again.release()
        if tier == "remote":
            assert served.state.leases_held() == 0
    finally:
        cc.reset_stats_for_tests()
        artifacts.reset_for_tests()


def test_cold_start_of_threads_builds_once(lease_dir):
    """The stampede in one process: N threads race a cold fingerprint;
    one builds, every other waits then fetches."""
    s = _store(lease_dir)
    builds, results, lock = [], [], threading.Lock()

    def cold_start():
        deadline = time.monotonic() + 30.0
        while True:
            members, _ = s.fetch(FP, record=False)
            if members is not None:
                break
            lease = s.acquire_compile_lease(FP)
            if lease.granted:
                members, _ = s.fetch(FP, record=False)
                if members is None:
                    try:
                        with lock:
                            builds.append(threading.get_ident())
                        time.sleep(0.05)   # the "build"
                        s.publish(FP, {"lib": b"so"})
                    finally:
                        lease.release()
                    members = {"lib": b"so"}
                else:
                    lease.release()
                break
            members, _ = s.wait_fetch(FP, deadline)
            if members is not None:
                break
            assert time.monotonic() < deadline, "waiter starved"
        with lock:
            results.append(members["lib"])

    threads = [threading.Thread(target=cold_start) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(builds) == 1 and results == [b"so"] * 6


#: a worker process of the cold start: a fake toolchain, builder and
#: loader, then the library down the ladder once the start file exists
_COLD_WORKER = """
import json, os, sys, time
sys.path.insert(0, %(repo)r)
from paddle_operator_tpu_torch import compile_cache as cc
from paddle_operator_tpu_torch.ops import _kernels

class Lib:
    def __init__(self, path):
        with open(path) as fh:
            self.spec = json.load(fh)

def build(name, path):
    with open(%(log)r, "a") as fh:
        fh.write("%%d\\n" %% os.getpid())
    time.sleep(1.0)   # long enough for every peer to be waiting
    with open(path, "w") as fh:
        json.dump({"name": name}, fh)
    return 1.0

cc.toolchain_and_device = lambda: {"device": "fake"}
cc._open_cdll = Lib
_kernels.build = build
while not os.path.exists(%(go)r):
    time.sleep(0.01)
lib = cc.load_library("fused_sgd")
print(json.dumps({"rung": lib.rung, "name": lib._cdll.spec["name"]}))
"""


@pytest.mark.parametrize("tier", ["local", "remote"])
def test_cold_start_of_processes_builds_once(tmp_path, served, tier):
    """Four fresh processes, each with its own empty cache dir, start
    the ladder together against one store: one builds, three fetch."""
    log, go = str(tmp_path / "builds.log"), str(tmp_path / "go")
    code = _COLD_WORKER % {"repo": REPO, "log": log, "go": go}
    env = dict(os.environ, TPUJOB_ARTIFACT_WAIT_S="60")
    if tier == "local":
        env.update(TPUJOB_ARTIFACT_STORE=str(tmp_path / "fleet"))
        env.pop("TPUJOB_ARTIFACT_URL", None)
    else:
        env.update(TPUJOB_ARTIFACT_STORE="0", TPUJOB_ARTIFACT_URL=served.url)
    procs = []
    for i in range(4):
        penv = dict(env, TPUJOB_COMPILE_CACHE_DIR=str(tmp_path / str(i)))
        procs.append(subprocess.Popen([sys.executable, "-c", code],
                                      env=penv, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        open(go, "w").close()
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    rungs = sorted(json.loads(o.split("\n")[-2])["rung"] for o, _ in outs)
    assert rungs == ["built", "fleet", "fleet", "fleet"]
    with open(log) as fh:
        assert len(fh.read().split()) == 1
    if tier == "remote":
        # one grant unless a process's acquire came after the build's
        # release (then its re-fetch under the lease finds the library)
        counts = served.state.snapshot()
        assert counts["lease_grant"] == counts["lease_release"] >= 1
        assert served.state.leases_held() == 0
