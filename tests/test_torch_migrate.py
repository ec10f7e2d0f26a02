"""The live-migration MOVE of the torch port against the JAX package's.

The port copies the artifact envelope, the store's two tiers, the HTTP
server and the state bundles (``paddle_operator_tpu_torch/artifacts/``),
and the runner's side of the handshake: the drain notice's intent
(``DrainMonitor``), the drained exit's publish of the final cut and the
destination's pre-stage before the first cycle. The JAX side is the
reference's own package, driven as ``tests/test_migration.py:58-141,
496-543`` and ``paddle_operator_tpu/chaos/migration.py:682-790`` drive
it.

* the reference's ``TestStateBundles`` on the port's copy, every case on
  the local tier and on the HTTP tier through the port's server;
* the two packages byte for byte: fingerprints, envelopes, packed step
  dirs, each client against the other's server, and a step dir the JAX
  package wrote restored by the port;
* ``DrainMonitor``'s intent, against the reference's;
* the runner, world of one on the CPU, over the port's server: a tiny GPT
  job moved at step 3 of 6 (the destination a fresh process) bitwise the
  unmigrated run, and the same tree moved through the JAX package's
  runner and server within ``tests/test_torch_elastic.py``'s tolerance;
  a poisoned bundle, an unparseable ``TPUJOB_MIGRATE_STATE``, no store, a
  world of two and a bundle over ``MAX_BUNDLE_BYTES`` (refused by the
  server while ``migrate_published`` is still reported, as in the
  reference) each fall back, never to a wrong restore.

JAX is imported where a test needs it (``pytest.importorskip``), so that
the GPU machine, which has none, runs the ``cuda`` test: the MOVE of
ResNet-50 at full width on the card, 2 steps, bitwise the unmigrated run.
"""

import json
import os

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import bridge, dp_check
from paddle_operator_tpu_torch import migrate_check as mc
from paddle_operator_tpu_torch.artifacts import bundle, reset_for_tests
from paddle_operator_tpu_torch.artifacts.server import ArtifactServer
from paddle_operator_tpu_torch.artifacts.state import (
    MANIFEST_MEMBER, STEP_DIR_FMT, fetch_state, pack_state_dir,
    publish_state, state_fingerprint)
from paddle_operator_tpu_torch.artifacts.store import ArtifactStore, \
    get_store, metrics_text
from paddle_operator_tpu_torch.runner import DrainMonitor
from paddle_operator_tpu_torch.utils import checkpoint as tckpt

#: the losses, relative, and the parameters, element by element of
#: max(1, the leaf's largest magnitude): tests/test_torch_elastic.py's
#: TOL and STATE_TOL, the GPT fp32 classes of the dp path
TOL = 2e-5
STATE_TOL = 1e-4
SEED, BATCH, SEQ, STEPS, MOVE_AT = 0, 8, 16, 6, 3
#: the JAX package's TINY_CONFIG (the port's is the same)
CFG = dict(vocab_size=1024, hidden=128, layers=2, heads=4, mlp_dim=256,
           max_seq=256, moe_experts=0, moe_every=2)
TIERS = ("local", "http")


def _jax():
    """The JAX package's modules the comparisons need; the tests that use
    them skip where jax is missing."""
    jax = pytest.importorskip("jax")
    from paddle_operator_tpu import artifacts as jart
    from paddle_operator_tpu import launch as jlaunch
    from paddle_operator_tpu import runner as jrunner
    from paddle_operator_tpu.artifacts import bundle as jbundle
    from paddle_operator_tpu.artifacts import server as jserver
    from paddle_operator_tpu.artifacts import state as jstate
    from paddle_operator_tpu.artifacts import store as jstore
    from paddle_operator_tpu.models import gpt as jgpt
    from paddle_operator_tpu.ops import optim as jopt
    from paddle_operator_tpu.utils import checkpoint as jckpt

    return dict(jax=jax, jnp=jax.numpy, art=jart, launch=jlaunch,
                runner=jrunner, bundle=jbundle, server=jserver,
                state=jstate, store=jstore, gpt=jgpt, optim=jopt,
                ckpt=jckpt)


# ---------------------------------------------------------------------------
# state bundles, on each tier
# ---------------------------------------------------------------------------

@pytest.fixture(params=TIERS)
def tier(request, tmp_path, monkeypatch):
    """The port's store client on one tier: the local dir, or HTTP only
    (the local tier off) through the port's server. Yields ``(store,
    store_dir, server or None)``."""
    store_dir = str(tmp_path / "store")
    if request.param == "local":
        monkeypatch.setenv("TPUJOB_ARTIFACT_STORE", store_dir)
        monkeypatch.delenv("TPUJOB_ARTIFACT_URL", raising=False)
        reset_for_tests()
        yield get_store(), store_dir, None
    else:
        with ArtifactServer("127.0.0.1:0", store_dir=store_dir) as srv:
            monkeypatch.setenv("TPUJOB_ARTIFACT_STORE", "0")
            monkeypatch.setenv("TPUJOB_ARTIFACT_URL", srv.url)
            reset_for_tests()
            yield get_store(), store_dir, srv
    reset_for_tests()


def _write_step(ckpt_dir, step, payload=b"weights", extra=()):
    step_dir = os.path.join(ckpt_dir, STEP_DIR_FMT % step)
    os.makedirs(step_dir, exist_ok=True)
    with open(os.path.join(step_dir, "state.npz"), "wb") as fh:
        fh.write(payload)
    with open(os.path.join(step_dir, "manifest.json"), "w") as fh:
        json.dump({"step": step, "committed": True}, fh)
    for name, data in extra:
        with open(os.path.join(step_dir, name), "wb") as fh:
            fh.write(data)
    return step_dir


def _bundles(store_dir):
    return sorted(f for f in os.listdir(store_dir)
                  if f.endswith(bundle.SUFFIX)) \
        if os.path.isdir(store_dir) else []


class TestStateBundles:
    def test_fingerprint_is_pure_hex_and_keyed_by_identity(self, tier,
                                                           tmp_path):
        store, store_dir, _ = tier
        fp = state_fingerprint("ns", "job", 7)
        assert len(fp) == 40 and int(fp, 16) >= 0
        # a KEY, not a content hash: distinct per job and per step
        assert fp != state_fingerprint("ns", "job", 8)
        assert fp != state_fingerprint("ns", "other", 7)
        assert fp == state_fingerprint("ns", "job", 7)
        # and the name the tier stores the bundle under
        _write_step(str(tmp_path / "src"), 7)
        assert publish_state(store, "ns", "job", 7,
                             str(tmp_path / "src")) == fp
        assert _bundles(store_dir) == [fp + bundle.SUFFIX]

    def test_publish_fetch_round_trip(self, tier, tmp_path):
        store, _, _ = tier
        src = str(tmp_path / "src")
        _write_step(src, 12, extra=[("shard_1.npz", b"more")])
        fp = publish_state(store, "ns", "mover", 12, src)
        assert fp == state_fingerprint("ns", "mover", 12)
        dst = str(tmp_path / "dst")
        got = fetch_state(store, fp, dst, 12)
        assert got == os.path.join(dst, STEP_DIR_FMT % 12)
        assert sorted(os.listdir(got)) == [
            "manifest.json", "shard_1.npz", "state.npz"]
        with open(os.path.join(got, "state.npz"), "rb") as fh:
            assert fh.read() == b"weights"
        # idempotent re-fetch: the assembled dir is returned as is
        assert fetch_state(store, fp, dst, 12) == got

    def test_missing_step_dir_publishes_nothing(self, tier, tmp_path):
        store, store_dir, _ = tier
        assert publish_state(store, "ns", "mover", 5,
                             str(tmp_path / "empty")) is None
        assert _bundles(store_dir) == []

    def test_unknown_fingerprint_fetches_nothing(self, tier, tmp_path):
        store, _, _ = tier
        fp = state_fingerprint("ns", "never-published", 3)
        dst = str(tmp_path / "dst")
        assert fetch_state(store, fp, dst, 3) is None
        assert not os.path.exists(os.path.join(dst, STEP_DIR_FMT % 3))

    def test_poisoned_bundle_is_rejected_never_half_restored(
            self, tier, tmp_path):
        """Flipped bytes in the stored bundle: the WHOLE assembly is
        discarded. Over HTTP the server verifies its own disk first: it
        quarantines the file and serves a miss, so the server's counter
        sees the poison and the client's does not."""
        store, store_dir, srv = tier
        src = str(tmp_path / "src")
        _write_step(src, 8)
        fp = publish_state(store, "ns", "mover", 8, src)
        path = os.path.join(store_dir, _bundles(store_dir)[0])
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        with open(path, "wb") as fh:
            fh.write(bytes(blob))
        dst = str(tmp_path / "dst")
        assert fetch_state(store, fp, dst, 8) is None
        assert not os.path.exists(os.path.join(dst, STEP_DIR_FMT % 8))
        # no half-assembled tmp dir left behind either
        assert (os.listdir(dst) if os.path.isdir(dst) else []) == []
        stats = store.stats()
        if srv is None:
            assert stats["poisoned_local"] == 1
        else:
            assert srv.state.snapshot()["poisoned_quarantined"] == 1
            assert stats["poisoned_remote"] == 0
        assert _bundles(store_dir) == []   # deleted, on either tier

    def test_listing_naming_outside_step_dir_is_rejected(self, tier,
                                                         tmp_path):
        """A corrupt shard listing must not write outside the
        destination step directory."""
        store, _, _ = tier
        fp = state_fingerprint("ns", "mover", 2)
        store.publish(fp, {
            MANIFEST_MEMBER: json.dumps(
                {"files": ["../escape"], "bytes": 1}).encode(),
            "../escape": b"x"})
        assert fetch_state(store, fp, str(tmp_path / "dst"), 2) is None
        assert not os.path.exists(str(tmp_path / "escape"))

    def test_pack_skips_empty_and_lists_members(self, tier, tmp_path):
        store, _, _ = tier
        assert pack_state_dir(str(tmp_path / "nope")) is None
        step_dir = _write_step(str(tmp_path / "c"), 4)
        members = pack_state_dir(step_dir)
        listing = json.loads(members[MANIFEST_MEMBER])
        assert sorted(listing["files"]) == ["manifest.json", "state.npz"]
        # the listing alone, member-scoped, from the tier
        fp = publish_state(store, "ns", "c", 4, str(tmp_path / "c"))
        got, where = store.fetch(fp, member=MANIFEST_MEMBER)
        assert list(got) == [MANIFEST_MEMBER]
        assert json.loads(got[MANIFEST_MEMBER]) == listing
        assert where == ("local" if tier[2] is None else "remote")


# ---------------------------------------------------------------------------
# the two packages, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ns,name,step", [("ns", "job", 7),
                                          ("default", "resnet50", 13),
                                          ("a-b", "c.d", 0)])
def test_state_fingerprint_matches_reference(ns, name, step):
    j = _jax()
    assert state_fingerprint(ns, name, step) == \
        j["state"].state_fingerprint(ns, name, step)


def test_envelope_bytes_match_reference():
    j = _jax()
    members = {"b": b"\x00\x01" * 100, "a": b"", "_state_manifest": b"{}"}
    fp = state_fingerprint("ns", "job", 1)
    ours = bundle.pack(fp, members)
    assert ours == j["bundle"].pack(fp, members)
    assert bundle.parse(ours, fp) == j["bundle"].parse(ours, fp) == members
    assert (bundle.MAGIC, bundle.MAX_BUNDLE_BYTES, bundle.SUFFIX) == (
        j["bundle"].MAGIC, j["bundle"].MAX_BUNDLE_BYTES, j["bundle"].SUFFIX)
    with pytest.raises(bundle.PoisonedArtifactError):
        bundle.parse(ours, state_fingerprint("ns", "job", 2))


def test_packed_step_dir_matches_reference(tmp_path):
    j = _jax()
    step_dir = _write_step(str(tmp_path), 3, payload=os.urandom(4096),
                           extra=[("shard_1.npz", b"more")])
    assert pack_state_dir(step_dir) == j["state"].pack_state_dir(step_dir)


@pytest.mark.parametrize("direction", ["port_client_reference_server",
                                       "reference_client_port_server"])
def test_clients_and_servers_interoperate(direction, tmp_path):
    """Each package's client publishes to and fetches from the other's
    server: the same wire, the same verification."""
    j = _jax()
    src = str(tmp_path / "src")
    _write_step(src, 5, payload=os.urandom(2048))
    fp = state_fingerprint("ns", "mover", 5)
    if direction == "port_client_reference_server":
        srv = j["server"].ArtifactServer("127.0.0.1:0",
                                         store_dir=str(tmp_path / "store"))
        client, publish, fetch = ArtifactStore, publish_state, fetch_state
    else:
        srv = ArtifactServer("127.0.0.1:0", store_dir=str(tmp_path / "store"))
        client, publish, fetch = (j["store"].ArtifactStore,
                                  j["state"].publish_state,
                                  j["state"].fetch_state)
    with srv:
        client = client(url=srv.url)
        assert publish(client, "ns", "mover", 5, src) == fp
        got = fetch(client, fp, str(tmp_path / "dst"), 5)
        assert srv.state.snapshot()["publish"] == 1
    assert sorted(os.listdir(got)) == ["manifest.json", "state.npz"]
    for name in ("manifest.json", "state.npz"):
        with open(os.path.join(got, name), "rb") as a, \
                open(os.path.join(src, STEP_DIR_FMT % 5, name), "rb") as b:
            assert a.read() == b.read()


def test_reference_checkpoint_moves_into_the_port(tmp_path, monkeypatch):
    """A step dir the JAX package's save_checkpoint wrote, published by
    the reference's publish_state to its store, fetched by the port's
    fetch_state over the HTTP tier and restored by the port's
    restore_checkpoint: the same arrays."""
    j = _jax()
    jnp = j["jnp"]
    state = {"params": {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
                        "b": [jnp.ones((4,), jnp.float32)]},
             "step": jnp.asarray(9, jnp.int32)}
    j["ckpt"].save_checkpoint(str(tmp_path / "src"), 9, state,
                              meta={"epoch": 0})
    with j["server"].ArtifactServer(
            "127.0.0.1:0", store_dir=str(tmp_path / "store")) as srv:
        fp = j["state"].publish_state(j["store"].ArtifactStore(url=srv.url),
                                      "ns", "mover", 9, str(tmp_path / "src"))
        assert fetch_state(ArtifactStore(url=srv.url), fp,
                           str(tmp_path / "dst"), 9) is not None
    restored, manifest = tckpt.restore_latest(str(tmp_path / "dst"))
    assert manifest["step"] == 9
    want = bridge.flatten(j["jax"].tree_util.tree_map(np.asarray, state))
    got = bridge.flatten(restored)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k


def test_client_exposition_matches_reference_less_leases(tmp_path,
                                                         monkeypatch):
    """The port's ``tpujob_artifact_*`` families, after one publish, a
    hit and a miss, are the reference's text, its compile-lease family
    included since the port has the leases; the fetch-seconds gauge is a
    wall time, so its samples are held by their labels alone."""
    j = _jax()
    monkeypatch.setenv("TPUJOB_ARTIFACT_STORE", str(tmp_path / "store"))
    monkeypatch.delenv("TPUJOB_ARTIFACT_URL", raising=False)
    reset_for_tests()
    j["art"].reset_for_tests()
    try:
        for get in (get_store, j["art"].get_store):
            store = get()
            store.publish("ab", {"x": b"1"})
            store.fetch("ab")
            store.fetch("cd")
        def text(lines):
            return [line.rsplit(" ", 1)[0] if line.startswith(
                "tpujob_artifact_fetch_seconds{") else line
                for line in lines]

        ref = j["art"].metrics_text().splitlines()
        assert text(metrics_text().splitlines()) == text(ref)
    finally:
        reset_for_tests()
        j["art"].reset_for_tests()


# ---------------------------------------------------------------------------
# DrainMonitor
# ---------------------------------------------------------------------------

def test_migrate_intent_is_none_without_a_move(tmp_path):
    assert DrainMonitor().migrate_intent() is None
    dm = DrainMonitor(migrate_file=str(tmp_path / "absent.json"))
    assert dm.migrate_intent() is None and not dm.requested()
    dm.request()   # a plain drain is no MOVE
    assert dm.requested() and dm.migrate_intent() is None


@pytest.mark.parametrize("text,want", [
    ('{"namespace": "ns", "name": "job"}', {"namespace": "ns",
                                            "name": "job"}),
    ('{"namespace": ', {}),
    ("[1, 2]", {}),
    ("", {})])
def test_migrate_file_intent_matches_reference(tmp_path, text, want):
    """The file arms ``requested()``; a well-formed intent is returned,
    a torn or non-object file gives ``{}``, as the reference's."""
    j = _jax()
    path = str(tmp_path / "migrate.json")
    with open(path, "w") as f:
        f.write(text)
    dm = DrainMonitor(migrate_file=path)
    assert dm.requested()
    assert dm.migrate_intent() == want
    assert j["runner"].DrainMonitor(
        migrate_file=path).migrate_intent() == want


def test_request_migrate_arms_the_drain():
    dm = DrainMonitor()
    intent = {"namespace": "ns", "name": "job"}
    dm.request_migrate(intent)
    assert dm.requested() and dm.migrate_intent() == intent
    intent["name"] = "changed"   # the monitor kept its own copy
    assert dm.migrate_intent()["name"] == "job"
    dm = DrainMonitor()
    dm.request_migrate()
    assert dm.requested() and dm.migrate_intent() == {}


# ---------------------------------------------------------------------------
# the runner: a world of one on the CPU
# ---------------------------------------------------------------------------

def _sc(tmp, name, tree=None, **kw):
    """A migrate_check scenario of the tiny GPT job, its checkpoint dir
    ``tmp/name``, from the tree saved at ``tree`` (default
    ``tmp/tree.npz``)."""
    return dict(name=name, model="gpt_tiny",
                tree=tree or str(tmp / "tree.npz"), batch=BATCH, seq=SEQ,
                vocab=CFG["vocab_size"], seed=SEED, steps=STEPS, every=2,
                ckpt_dir=str(tmp / name), **kw)


def _notice(tmp, at=MOVE_AT - 1, **kw):
    kw.setdefault("intent", {"namespace": "ns", "name": "mover"})
    return {"file": str(tmp / "migrate.json"), "at": at, **kw}


@pytest.fixture(scope="module")
def moved(tmp_path_factory):
    """The tiny GPT job (fp32, adamw, from the JAX-initialised tree of
    tests/test_torch_elastic.py, carried as numpy) through the port's
    runner over the port's server: unmigrated, and
    moved at step MOVE_AT, the source in this process (the notice written
    from step MOVE_AT's loss call) and the destination a fresh process
    with a checkpoint dir of its own."""
    j = _jax()
    tmp = tmp_path_factory.mktemp("migrate")
    tree = j["jax"].tree_util.tree_map(
        np.asarray, j["gpt"].init(j["jax"].random.PRNGKey(SEED), CFG))
    dp_check.save_tree(str(tmp / "tree.npz"), tree)
    out = {"tmp": tmp, "tree": tree, "tree_path": str(tmp / "tree.npz")}
    with ArtifactServer("127.0.0.1:0", store_dir=str(tmp / "store")) as srv, \
            mc.environ(TPUJOB_ARTIFACT_STORE="0", TPUJOB_ARTIFACT_URL=srv.url,
                       TPUJOB_MIGRATE_FILE=str(tmp / "migrate.json"),
                       TPUJOB_MIGRATE_STATE=None):
        reset_for_tests()
        out["ref"] = mc.run_scenario(_sc(tmp, "ref"), keep_state=True)
        out["src"] = mc.run_scenario(_sc(tmp, "src", notice=_notice(tmp)))
        out["publishes"] = srv.state.snapshot()["publish"]
        os.remove(str(tmp / "migrate.json"))
        with mc.environ(TPUJOB_MIGRATE_FILE=None):
            out["dst"] = mc.launch(
                {"out": str(tmp / "pod"), "scenarios": [_sc(tmp, "dst")]},
                env={"TPUJOB_MIGRATE_STATE": "ns/mover:%d" % MOVE_AT,
                     "TPUJOB_ARTIFACT_URL": srv.url,
                     "TPUJOB_ARTIFACT_STORE": "0"},
                timeout=120)["dst"]
        out["server"] = srv.state.snapshot()
    reset_for_tests()
    return out


def test_run_migration_recovery_is_bitwise(moved):
    """The port's ``run_migration_recovery``: the source drains as a MOVE
    at step 3 and publishes once; the destination pre-stages and restores
    step 3 and finishes; every step's loss and the final state are the
    unmigrated run's, bit for bit."""
    ref, src, dst = moved["ref"], moved["src"], moved["dst"]
    assert src["drained"] and src["drain_step"] == MOVE_AT
    assert src["drain_reason"] == "migrate"
    assert src["migrate_published"] == {
        "fp": state_fingerprint("ns", "mover", MOVE_AT), "step": MOVE_AT}
    assert moved["publishes"] == 1
    assert set(src["migrate_stages"]) == {"publish_s"}
    assert dst["migrate_prefetched_step"] == MOVE_AT
    assert dst["resume_steps"] == [MOVE_AT] and dst["steps"] == STEPS
    assert set(dst["migrate_stages"]) == {"prestage_s"}
    assert src["losses"] + dst["losses"] == ref["losses"]
    assert dst["final_digest"] == ref["final_digest"]
    # the listing, manifest.json and state.npz, each on its own GET
    assert moved["server"]["fetch_hit"] == 3
    assert not [n for n in os.listdir(str(moved["tmp"] / "dst"))
                if n.startswith(".prestage_")]
    parts = mc.blackout(src, dst)
    assert parts["process_start_s"] > 0 and parts["first_step_s"] > 0
    assert abs(sum(v for k, v in parts.items() if k != "total_s")
               - parts["total_s"]) < 1e-6


def _jax_move(j, tmp, tree, name, drain_at=None, state=None):
    """The reference's runner on the tiny GPT job (``chaos/migration.py``
    ``run_migration_recovery``'s flow, the loader synchronous): losses
    from a callback in the loss; a MOVE requested when the loader draws
    the batch of step ``drain_at + 1`` (drained at that step's end), or
    the destination of ``state`` ("ns/name:step")."""
    jax, jnp = j["jax"], j["jnp"]
    losses = []

    def loss_fn(p, b):
        loss, aux = j["gpt"].loss_fn(p, b, dtype=jnp.float32)
        jax.debug.callback(lambda v: losses.append(float(v)), loss)
        return loss, aux

    dm = j["runner"].DrainMonitor()

    def make_batch(rng, step):
        if step == drain_at:
            dm.request_migrate({"namespace": "ns", "name": "mover"})
        return {"input_ids": jnp.asarray(mc.elastic_check.numpy_batch(
            SEED, step, BATCH, SEQ, CFG["vocab_size"]))}

    job = j["runner"].TrainJob(
        init_params=lambda rng: jax.tree_util.tree_map(jnp.asarray, tree),
        loss_fn=loss_fn, optimizer=j["optim"].adamw(1e-3),
        make_batch=make_batch, mesh_axes=lambda world: {"dp": world},
        total_steps=STEPS, checkpoint_every=2,
        checkpoint_dir=str(tmp / name), log_every=0, prefetch=0,
        drain_monitor=dm)
    with mc.environ(TPUJOB_MIGRATE_STATE=state):
        out = j["runner"].run_training(
            job, cfg=j["launch"].LaunchConfig(worker_id=0, num_workers=1),
            init_distributed=False)
    jax.effects_barrier()
    return out, losses


def test_move_matches_the_reference_runner(moved, monkeypatch):
    """The same tree moved through the JAX package's runner and server:
    the same drain step and pre-staged step, every step's loss within TOL
    and the final parameters within STATE_TOL of the port's."""
    j = _jax()
    tmp = moved["tmp"]
    monkeypatch.setenv("TPUJOB_COMPILE_CACHE", "0")
    with j["server"].ArtifactServer(
            "127.0.0.1:0", store_dir=str(tmp / "jstore")) as srv:
        monkeypatch.setenv("TPUJOB_ARTIFACT_STORE", "0")
        monkeypatch.setenv("TPUJOB_ARTIFACT_URL", srv.url)
        j["art"].reset_for_tests()
        try:
            src, src_losses = _jax_move(j, tmp, moved["tree"], "jsrc",
                                        drain_at=MOVE_AT - 1)
            assert src["drained"] and src["drain_reason"] == "migrate"
            step = src["drain_step"]
            assert step == MOVE_AT
            assert src["migrate_published"]["step"] == step
            dst, dst_losses = _jax_move(j, tmp, moved["tree"], "jdst",
                                        state="ns/mover:%d" % step)
        finally:
            j["art"].reset_for_tests()
    assert dst["migrate_prefetched_step"] == step
    port = [float.fromhex(h) for h in moved["src"]["losses"]
            + moved["dst"]["losses"]]
    ref = src_losses[:step] + dst_losses
    assert len(ref) == len(port) == STEPS, (step, len(src_losses))
    for got, want in zip(port, ref):
        assert abs(got - want) <= TOL * abs(want), (port, ref)
    # the port's destination ends on the unmigrated run's state
    got = bridge.flatten(bridge.params_to_numpy(
        moved["ref"]["state"]["params"]))
    want = bridge.flatten(j["jax"].tree_util.tree_map(
        np.asarray, dst["state"]["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        err = np.max(np.abs(np.asarray(got[k], np.float64) - want[k]))
        assert err <= STATE_TOL * max(1.0, np.max(np.abs(want[k]))), (k, err)


@pytest.fixture
def port_server(tmp_path, monkeypatch):
    """The port's server, the HTTP tier only, the MOVE env unset."""
    with ArtifactServer("127.0.0.1:0", store_dir=str(tmp_path / "store")) \
            as srv:
        monkeypatch.setenv("TPUJOB_ARTIFACT_STORE", "0")
        monkeypatch.setenv("TPUJOB_ARTIFACT_URL", srv.url)
        monkeypatch.delenv("TPUJOB_MIGRATE_STATE", raising=False)
        monkeypatch.delenv("TPUJOB_MIGRATE_FILE", raising=False)
        reset_for_tests()
        yield srv
    reset_for_tests()


def _fresh(moved, line):
    """A destination that fell back: nothing pre-staged or restored, and
    the unmigrated run's losses and state, bit for bit."""
    assert line["migrate_prefetched_step"] is None
    assert line["resume_steps"] == []
    assert line["losses"] == moved["ref"]["losses"]
    assert line["final_digest"] == moved["ref"]["final_digest"]


def test_runner_rejects_poisoned_state_bundle(moved, port_server, tmp_path,
                                              monkeypatch):
    """The reference's test on the port: garbage published under the
    exact fingerprint the destination asks for, a byte flipped on the
    server's disk; the destination trains from scratch to the untouched
    run's loss."""
    fp = state_fingerprint("chaos", "mover", 3)
    get_store().publish(fp, {
        MANIFEST_MEMBER: json.dumps(
            {"files": ["state.npz"], "bytes": 4}).encode(),
        "state.npz": b"junk"})
    path = os.path.join(port_server.store_dir, fp + bundle.SUFFIX)
    blob = bytearray(open(path, "rb").read())
    blob[-3] ^= 0xFF
    with open(path, "wb") as fh:
        fh.write(bytes(blob))
    monkeypatch.setenv("TPUJOB_MIGRATE_STATE", "chaos/mover:3")
    line = mc.run_scenario(_sc(tmp_path, "poisoned", moved["tree_path"]))
    _fresh(moved, line)
    assert port_server.state.snapshot()["poisoned_quarantined"] == 1


@pytest.mark.parametrize("spec", ["garbage", "ns/mover:x", "ns/mover:",
                                  "/mover:3", "ns/:3"])
def test_unparseable_migrate_state_is_ignored(moved, port_server, tmp_path,
                                              monkeypatch, spec):
    monkeypatch.setenv("TPUJOB_MIGRATE_STATE", spec)
    line = mc.run_scenario(_sc(tmp_path, "bad", moved["tree_path"]))
    _fresh(moved, line)
    assert "prestage_s" not in line["migrate_stages"]
    assert port_server.state.snapshot()["fetch_miss"] == 0


def test_move_without_a_store_is_a_plain_drain(moved, tmp_path,
                                               monkeypatch):
    for k in ("TPUJOB_ARTIFACT_STORE", "TPUJOB_ARTIFACT_URL"):
        monkeypatch.delenv(k, raising=False)
    reset_for_tests()
    monkeypatch.setenv("TPUJOB_MIGRATE_FILE", str(tmp_path / "migrate.json"))
    line = mc.run_scenario(_sc(tmp_path, "nostore", moved["tree_path"],
                               notice=_notice(tmp_path)))
    assert line["drained"] and line["drain_step"] == MOVE_AT
    assert line["drain_reason"] == "migrate"
    assert line["migrate_published"] is None
    assert line["migrate_stages"] == {}
    assert line["losses"] == moved["ref"]["losses"][:MOVE_AT]
    # the cut is durable all the same
    assert tckpt.latest_step(str(tmp_path / "nostore")) == MOVE_AT


def test_world_of_two_publishes_nothing(moved, port_server, tmp_path):
    """Two gloo workers get the notice: both drain at step 3 as a MOVE,
    and neither publishes (the reference publishes from one process
    only)."""
    sc = _sc(tmp_path, "two", moved["tree_path"], notice=_notice(tmp_path))
    spec = {"out": str(tmp_path / "w"), "scenarios": [sc]}
    lines = dp_check.launch_workers(
        spec, world=2, timeout=120, env={
            "TPUJOB_MIGRATE_FILE": str(tmp_path / "migrate.json"),
            "OMP_NUM_THREADS": "1"},
        script=os.path.abspath(mc.__file__))
    for rank_lines in lines:
        line, = rank_lines
        assert line["drained"] and line["drain_step"] == MOVE_AT
        assert line["drain_reason"] == "migrate"
        assert line["migrate_published"] is None
    assert port_server.state.snapshot()["publish"] == 0


def test_bundle_over_the_limit_falls_back(moved, port_server, tmp_path,
                                          monkeypatch):
    """A state over ``MAX_BUNDLE_BYTES``: the server refuses the PUT, the
    source still reports ``migrate_published`` (the reference's
    behaviour, which the port mirrors), and the destination's pre-stage
    misses and it trains from step 0: never a wrong restore."""
    monkeypatch.setattr(bundle, "MAX_BUNDLE_BYTES", 64 * 1024)
    monkeypatch.setenv("TPUJOB_MIGRATE_FILE", str(tmp_path / "migrate.json"))
    src = mc.run_scenario(_sc(tmp_path, "big_src", moved["tree_path"],
                              notice=_notice(tmp_path)))
    assert os.path.getsize(os.path.join(
        str(tmp_path / "big_src"), STEP_DIR_FMT % MOVE_AT,
        "state.npz")) > bundle.MAX_BUNDLE_BYTES
    assert src["migrate_published"]["step"] == MOVE_AT
    counts = port_server.state.snapshot()
    assert counts["publish"] == 0 and counts["publish_rejected"] >= 1
    monkeypatch.delenv("TPUJOB_MIGRATE_FILE")
    monkeypatch.setenv("TPUJOB_MIGRATE_STATE", "ns/mover:%d" % MOVE_AT)
    _fresh(moved, mc.run_scenario(_sc(tmp_path, "big_dst",
                                      moved["tree_path"])))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: B1 (csrc/fused_sgd.cu) has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_resnet50_move_is_bitwise(cuda_device, tmp_path):
    """ResNet-50 at full width (224x224, batch 128, fused_sgd) moved at
    step 1 of 2 over the port's server: the destination, a fresh process,
    pre-stages step 1 and reproduces the unmigrated run's step 2 bit for
    bit, one B1 launch a step on each side."""
    def sc(name, **kw):
        return dict(name=name, model="resnet50", depth=50, classes=1000,
                    image=224, batch=128, schedule=30, steps=2, every=10,
                    ckpt_dir=str(tmp_path / name), **kw)

    with ArtifactServer("127.0.0.1:0", store_dir=str(tmp_path / "store")) \
            as srv, mc.environ(TPUJOB_ARTIFACT_STORE="0",
                               TPUJOB_ARTIFACT_URL=srv.url,
                               TPUJOB_MIGRATE_STATE=None,
                               TPUJOB_MIGRATE_FILE=str(tmp_path / "m.json")):
        reset_for_tests()
        ref = mc.run_scenario(sc("ref"))
        src = mc.run_scenario(sc("src", notice={
            "file": str(tmp_path / "m.json"), "at": 0,
            "intent": {"namespace": "smoke", "name": "resnet50"}}))
        os.remove(str(tmp_path / "m.json"))
        with mc.environ(TPUJOB_MIGRATE_FILE=None):
            dst = mc.launch({"out": str(tmp_path / "pod"),
                             "scenarios": [sc("dst")]},
                            env={"TPUJOB_MIGRATE_STATE": "smoke/resnet50:1",
                                 "TPUJOB_ARTIFACT_URL": srv.url,
                                 "TPUJOB_ARTIFACT_STORE": "0"})["dst"]
    reset_for_tests()
    assert src["drain_reason"] == "migrate" and src["drain_step"] == 1
    assert src["migrate_published"]["step"] == 1
    assert dst["migrate_prefetched_step"] == 1 and dst["resume_steps"] == [1]
    assert src["losses"] + dst["losses"] == ref["losses"]
    assert dst["final_digest"] == ref["final_digest"]
    assert src["launches"]["fused_sgd"] == dst["launches"]["fused_sgd"] == 1
