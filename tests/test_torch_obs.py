"""The port's worker plane (``paddle_operator_tpu_torch/obs/worker.py``)
and the runner's observability against the JAX package's: the step
profiler, the straggler detector and the throughput baseline fed the same
samples, the ``/metrics`` text of the same updates (parsed by the
reference's strict parser), the runner's step profile, straggler events,
goodput ledger, metrics endpoint and incident adoption
(``tests/test_goodput.py``, ``tests/test_observability.py``,
``tests/test_incidents.py``), the loader's inline mode and queue gauge,
the checkpoint observer's events against the reference's for the same
run, and a world of four gloo workers with one slowed rank."""

import json
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch import dp_check
from paddle_operator_tpu_torch.data import ShardedLoader
from paddle_operator_tpu_torch.models import gpt as tgpt
from paddle_operator_tpu_torch.obs import worker as tworker
from paddle_operator_tpu_torch import compile_cache
from paddle_operator_tpu_torch.ops import optim as topt
from paddle_operator_tpu_torch import runner as trunner
from paddle_operator_tpu_torch.runner import TrainJob, run_training
from paddle_operator_tpu_torch.utils import checkpoint as tckpt
from paddle_operator_tpu_torch.utils import trace as ttrace

jax = pytest.importorskip("jax")

from paddle_operator_tpu.obs import parse_exposition  # noqa: E402
from paddle_operator_tpu.obs import worker as jworker  # noqa: E402
from paddle_operator_tpu.utils import checkpoint as jckpt  # noqa: E402


def _loss(params, batch):
    return tgpt.loss_fn(params, batch, dtype=torch.float32)


def _job(total=4, **kw):
    """A tiny GPT (``TINY_CONFIG``, 8 x 16 tokens, adamw) on the CPU."""
    kw.setdefault("log_every", 1)
    return TrainJob(
        init_params=lambda gen: tgpt.init(gen, tgpt.TINY_CONFIG),
        loss_fn=kw.pop("loss_fn", _loss), optimizer=topt.adamw(1e-3),
        make_batch=lambda gen, step: tgpt.synthetic_batch(gen, 8, 16, 1024),
        total_steps=total, device="cpu", **kw)


def _conserves(d, tol=2e-3):
    attributed = d["goodput_s"] + sum(d["badput_s"].values())
    return abs(attributed - d["wall_s"]) < tol


# ---------------------------------------------------------------------------
# the worker plane, fed the same samples as the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth,n", [(16, 100), (512, 40), (4, 3)])
def test_step_profiler_matches_the_reference(depth, n):
    port, ref = tworker.StepProfiler(depth), jworker.StepProfiler(depth)
    for i in range(n):
        phases = dict(dispatch=0.01 * (i % 4 + 1), data_wait=0.001 * i)
        if i % 3 == 0:
            phases["checkpoint"] = 0.5
        if i % 5 == 0:
            phases["d2h"] = -1.0          # negatives are dropped
        port.record(i, **phases)
        ref.record(i, **phases)
    assert len(port) == len(ref) == min(depth, n)
    assert port.stats() == ref.stats()
    assert port.totals() == ref.totals()
    for phase in ("dispatch", "checkpoint", "missing"):
        assert port.p50(phase) == ref.p50(phase)


@pytest.mark.parametrize("gang,k", [
    ({0: 0.010, 1: 0.011, 2: 0.010, 3: 0.050}, 2.0),
    ({i: 0.01 for i in range(8)}, 2.0),
    ({0: 0.010, 1: 0.012, 2: 0.011, 3: 0.013}, 2.0),
    ({0: 0.01, 1: 0.9}, 2.0),
    ({0: 0.0, 1: 0.0, 2: 0.0}, 2.0),
    ({"a": 1.0, "b": 1.1, "c": 3.0, "d": 0.9}, 1.5),
    ({0: 1.0, 1: 1.0, 2: 9.0, 3: 9.5, 4: 1.0}, 2.0)])
def test_straggler_detector_matches_the_reference(gang, k):
    assert tworker.StragglerDetector(k=k).evaluate(gang) == \
        jworker.StragglerDetector(k=k).evaluate(gang)
    assert tworker.median(list(gang.values())) == \
        jworker.median(list(gang.values()))


def test_straggler_k_below_one_is_refused():
    with pytest.raises(ValueError):
        tworker.StragglerDetector(k=0.5)


@pytest.mark.parametrize("samples", [
    [100, 100, 100, 10, 10, 80],
    [100, 90, 110, 120, 20, 30, 60, 100],
    [5, 5, 5, 5, 5],
    [100, 1, 100, 1, 100, 1]])
def test_throughput_baseline_matches_the_reference(samples):
    port, ref = tworker.ThroughputBaseline(), jworker.ThroughputBaseline()
    for s in samples:
        assert port.observe(s) == ref.observe(s)
    assert port.baseline == ref.baseline and port.degraded == ref.degraded


def _feed(srv):
    srv.update(steps_total=12, steps_per_second=3.25,
               examples_per_second=26.0, loss=float("nan"),
               loader_queue_depth=2, goodput_ratio=0.85, mfu=0.031,
               arithmetic_intensity=None)
    srv.set_stage_summary({"batch_build": {"ms": 10.0, "count": 12,
                                           "mean_ms": 0.83},
                           'we"ird\nstage': {"ms": 1.0, "count": 1}})
    srv.set_step_stats({"dispatch": {"p50": 0.1, "p90": 0.2, "p99": 0.3,
                                     "mean": 0.15, "count": 9}})
    srv.set_badput({"checkpoint": 0.5, "data_stall": 0.01})
    srv.set_hbm({"in_use": 1.5e9, "peak": 2e9, "limit": 8e10})
    srv.inc("tpujob_straggler_total")
    srv.inc("tpujob_straggler_total", 2)
    srv.inc("tpujob_worker_backend_degraded_total")


def test_metrics_text_is_the_references():
    """The same updates render the reference's text, byte for byte, and
    its strict parser finds nothing wrong with it."""
    port, ref = tworker.WorkerMetricsServer(), jworker.WorkerMetricsServer()
    try:
        _feed(port)
        _feed(ref)
        text = port.metrics_text()
        assert text == ref.metrics_text()
    finally:
        port.stop()
        ref.stop()
    assert parse_exposition(text) == []
    for family in ("tpujob_worker_steps_total 12", "tpujob_worker_mfu",
                   "tpujob_worker_loss NaN", "tpujob_straggler_total 3",
                   'tpujob_worker_badput_seconds_total{cause="checkpoint"}',
                   'tpujob_worker_hbm_bytes{kind="limit"}'):
        assert family in text
    assert "arithmetic_intensity" not in text


@pytest.mark.parametrize("text", [
    "# HELP a x\n# TYPE a gauge\na 1\n",
    "# TYPE a gauge\na 1\nb 2\n",
    "# TYPE a gauge\n# TYPE a gauge\na 1\n",
    "# TYPE a counter\n# TYPE b gauge\nb 1\na 2\n",
    '# TYPE a gauge\na{x="1",y="q\\"z"} 1\n',
    '# TYPE a gauge\na{x="1" 1\n',
    '# TYPE a gauge\na{x=1} 1\n',
    "# TYPE h histogram\nh_bucket{le=\"1\"} 1\nh_sum 2\nh_count 1\n",
    "# TYPE a wobble\na one\n",
    "# TYPE 9a gauge\n9a 1\n"])
def test_parse_exposition_matches_the_references(text):
    from paddle_operator_tpu_torch.obs import parse_exposition as port_parse

    assert port_parse(text) == parse_exposition(text)


def test_worker_metrics_server_serves_over_http():
    s = tworker.WorkerMetricsServer().start()
    try:
        s.update(steps_total=12, loader_queue_depth=2, goodput_ratio=0.85)
        with urllib.request.urlopen(s.url + "/metrics", timeout=5) as resp:
            assert resp.status == 200
            text = resp.read().decode()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(s.url + "/other", timeout=5)
    finally:
        s.stop()
    assert parse_exposition(text) == []
    assert "tpujob_worker_steps_total 12" in text
    assert "tpujob_worker_goodput_ratio 0.85" in text


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gang,events", [
    (lambda own: {0: own, 1: own / 10, 2: own / 10, 3: own / 10}, "some"),
    (lambda own: {0: own, 1: own, 2: own, 3: own}, "none")])
def test_runner_straggler_detection_with_an_injected_gang(gang, events):
    """This worker's p50 at 10x the gang's is the straggler; a uniform
    gang flags no one. The step profile and a conserving goodput_detail
    come with every run."""
    res = run_training(_job(gang_p50_source=gang))
    if events == "some":
        assert res["straggler_events"] >= 1
    else:
        assert res["straggler_events"] == 0
    assert len(res["gang_p50"]) == 4
    assert res["step_profile"]["dispatch"]["count"] >= 4
    assert {"data_wait", "d2h"} <= set(res["step_profile"])
    assert "collective" not in res["step_profile"]    # one process
    assert _conserves(res["goodput_detail"])
    assert res["backend_degraded_events"] == 0


def test_runner_reports_goodput_and_serves_metrics(monkeypatch):
    """metrics_port=0: the endpoint is up while the run trains (scraped
    from a thread at step 3), its text parses under the reference's
    parser, and the run reports goodput."""
    made = []

    class Server(tworker.WorkerMetricsServer):
        def __init__(self, bind=":0"):
            super().__init__(bind)
            made.append(self)

    monkeypatch.setattr(trunner, "WorkerMetricsServer", Server)
    scraped = []

    def scrape():
        with urllib.request.urlopen(made[0].url + "/metrics",
                                    timeout=5) as resp:
            scraped.append(resp.read().decode())

    calls = {"n": 0}

    def loss_fn(params, batch):
        calls["n"] += 1
        if calls["n"] == 4:
            t = threading.Thread(target=scrape)
            t.start()
            t.join(timeout=10)
        return _loss(params, batch)

    res = run_training(_job(total=5, metrics_port=0, loss_fn=loss_fn))
    assert res["steps"] == 5
    assert 0.0 < res["goodput"] <= 1.0
    assert res["worker_metrics_url"] == made[0].url
    assert len(scraped) == 1 and parse_exposition(scraped[0]) == []
    assert "tpujob_worker_steps_total 2" in scraped[0]
    assert "tpujob_worker_mfu" in scraped[0]
    final = made[0].metrics_text()
    assert parse_exposition(final) == []
    assert "tpujob_worker_steps_total 5" in final
    assert 'tpujob_worker_badput_seconds_total{cause="data_stall"}' in final
    with pytest.raises(OSError):          # stopped with the run
        urllib.request.urlopen(made[0].url + "/metrics", timeout=2)


def test_a_taken_metrics_port_degrades_to_training_without_metrics():
    sock = socket.socket()
    sock.bind(("0.0.0.0", 0))
    sock.listen(1)
    try:
        res = run_training(_job(total=2,
                                metrics_port=sock.getsockname()[1]))
    finally:
        sock.close()
    assert res["steps"] == 2 and "worker_metrics_url" not in res


@pytest.mark.parametrize("value,served", [("0", True), ("nope", False)])
def test_metrics_port_from_the_environment(monkeypatch, value, served):
    monkeypatch.setenv("TPUJOB_WORKER_METRICS_PORT", value)
    res = run_training(_job(total=1))
    assert ("worker_metrics_url" in res) == served


def test_runner_badput_causes_conserve(tmp_path, monkeypatch):
    """A resumed run charges its restore, its saves and the seconds spent
    building kernels during it (here a build faked inside a step, so it
    overlaps the dispatch and is scaled into the remainder), and the
    ledger still conserves."""
    d = str(tmp_path)
    run_training(_job(total=2, checkpoint_every=2, checkpoint_dir=d))

    def loss_fn(params, batch):
        stats = compile_cache._state.stats
        monkeypatch.setitem(stats, "compile_seconds",
                            stats["compile_seconds"] + 0.25)
        return _loss(params, batch)

    res = run_training(_job(total=4, checkpoint_every=2, checkpoint_dir=d,
                            loss_fn=loss_fn))
    assert res["resume_steps"] == [2]
    causes = res["goodput_detail"]["badput_s"]
    assert {"restore", "checkpoint", "compile"} <= set(causes)
    assert _conserves(res["goodput_detail"])
    assert res["step_profile"]["checkpoint"]["count"] == 1


def test_backend_degraded_events():
    """Examples/s collapsing against the run's own baseline counts a
    backend_degraded event and the metrics counter, as the reference's
    self-check does (the observer's boundary fed the rates directly)."""
    from paddle_operator_tpu_torch.launch import detect_env

    result = {}
    obs = trunner._Observer(_job(metrics_port=0), detect_env(),
                            torch.device("cpu"), result)
    try:
        for rate in (10.0, 10.0, 10.0, 1.0, 1.0, 9.0):
            obs.boundary(1, rate, 0.5, 4, 0)
        text = obs.metrics.metrics_text()
    finally:
        obs.close()
    assert result["backend_degraded_events"] == 1
    assert "tpujob_worker_backend_degraded_total 1" in text
    assert parse_exposition(text) == []


@pytest.mark.parametrize("kw,fmt", [({"async_checkpoint": False}, None),
                                    ({"sharded_checkpoint": True},
                                     "sharded")])
def test_checkpoint_modes_save_and_resume(tmp_path, kw, fmt):
    """A world of one saving synchronously, or in the sharded format,
    writes the step the default background writer writes (read back by
    the reference's ``restore_latest``, leaf for leaf), and resumes from
    it to the losses of an uninterrupted run."""
    d, default = str(tmp_path / "mode"), str(tmp_path / "default")
    losses = []

    def loss_fn(params, batch):
        loss, aux = _loss(params, batch)
        losses.append(loss.item())
        return loss, aux

    run_training(_job(total=2, checkpoint_every=2, checkpoint_dir=d,
                      loss_fn=loss_fn, **kw))
    assert tckpt.read_manifest(d).get("format") == fmt
    run_training(_job(total=2, checkpoint_every=2, checkpoint_dir=default))
    got, manifest = jckpt.restore_latest(d)
    want, _ = jckpt.restore_latest(default)
    assert manifest["step"] == 2
    flat_got, flat_want = jckpt._flatten(got), jckpt._flatten(want)
    assert sorted(flat_got) == sorted(flat_want)
    for k, v in flat_want.items():
        assert np.array_equal(np.asarray(flat_got[k]), np.asarray(v)), k
    res = run_training(_job(total=4, checkpoint_every=2, checkpoint_dir=d,
                            loss_fn=loss_fn, **kw))
    resumed, losses[:] = list(losses), []
    run_training(_job(total=4, loss_fn=loss_fn))
    assert res["resume_steps"] == [2] and tckpt.latest_step(d) == 4
    assert resumed == losses


def test_runner_adopts_an_incident_stamps_stages_and_clears(tmp_path,
                                                            monkeypatch):
    """As the reference's runner: a resumed run carrying
    TPUJOB_TRACE_CONTEXT adopts it, reports its restore, compile and
    warmup stages, stamps records until its first step and clears."""
    path = str(tmp_path / "run.jsonl")
    monkeypatch.setattr(ttrace, "_global", ttrace.Tracer(path=path))
    d = str(tmp_path / "ck")
    monkeypatch.delenv("TPUJOB_TRACE_CONTEXT", raising=False)
    run_training(_job(total=2, checkpoint_every=2, checkpoint_dir=d,
                      log_every=0))
    ctx = ttrace.SpanContext("i-test-77", "drain", "default/tiny")
    monkeypatch.setenv("TPUJOB_TRACE_CONTEXT", ctx.encode())
    res = run_training(_job(total=4, checkpoint_every=2, checkpoint_dir=d,
                            log_every=0))
    ttrace.tracer().close()
    assert res["steps"] == 4
    assert ttrace.current_incident_context() is None
    records = [json.loads(line) for line in open(path)]
    adopted = [r for r in records if r["name"] == "incident_adopted"]
    assert len(adopted) == 1
    assert adopted[0]["attrs"]["incident"] == ctx.incident_id
    stages = {r["attrs"]["stage"]: r["attrs"]
              for r in records if r["name"] == "incident_stage"}
    assert set(stages) >= {"restore", "compile", "warmup"}
    for attrs in stages.values():
        assert attrs["plane"] == "runner" and attrs["dur_s"] > 0
        assert attrs["incident"] == ctx.incident_id
    first = [r for r in records if r["name"] == "incident_first_step"]
    assert len(first) == 1 and first[0]["attrs"]["step"] == 3
    steps = [(r["attrs"]["step"], r["attrs"].get("incident"))
             for r in records if r["name"] == "train_step"]
    assert (3, ctx.incident_id) in steps and (4, None) in steps
    assert all(inc is None for s, inc in steps if s <= 2)
    saves = [r for r in records if r["name"] == "checkpoint_save"]
    assert [r["attrs"]["step"] for r in saves] == [2, 4]


def test_a_mangled_context_traces_uncorrelated(monkeypatch):
    monkeypatch.setenv("TPUJOB_TRACE_CONTEXT", "v9;garbage")
    res = run_training(_job(total=1))
    assert res["steps"] == 1 and ttrace.current_incident_context() is None


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

def _source(n=10):
    return iter([{"x": np.full((2,), i, np.float32)} for i in range(n)])


def test_loader_queue_depth_gauge():
    with ShardedLoader(_source(), device="cpu", prefetch=3) as loader:
        next(loader)
        assert 0 <= loader.queue_depth() <= 3
        assert loader.producer_alive()
    assert not loader.producer_alive()


@pytest.mark.parametrize("prefetch", [0, 1, 2, 5])
def test_loader_prefetch_depths_give_the_same_batches(prefetch):
    with ShardedLoader(_source(), device="cpu",
                       prefetch=prefetch) as loader:
        got = [float(b["x"][0]) for b in loader]
        if prefetch == 0:
            assert loader.queue_depth() == 0
            assert not loader.producer_alive()
    assert got == [float(i) for i in range(10)]


def test_inline_loader_reraises_and_times_the_pull():
    def source():
        yield {"x": np.zeros(2, np.float32)}
        raise KeyError("broken source")

    times = ttrace.StageTimes()
    loader = ShardedLoader(source(), device="cpu", prefetch=0, timings=times)
    next(loader)
    with pytest.raises(KeyError):
        next(loader)
    assert times.summary()["batch_build"]["count"] == 2


def test_runner_trains_the_same_inline(tmp_path):
    def run(prefetch):
        losses = []

        def loss_fn(params, batch):
            out = _loss(params, batch)
            losses.append(out[0].item())
            return out

        run_training(_job(total=3, prefetch=prefetch, loss_fn=loss_fn))
        return losses

    assert run(0) == run(2)


# ---------------------------------------------------------------------------
# the checkpoint observer
# ---------------------------------------------------------------------------

def _observed(mod, ckpt_dir, state):
    """Save steps 1-5 (keep 3), take a duplicate save through the async
    writer, quarantine the newest as corrupt, restore: the events the
    observer saw, without the directory."""
    seen = []
    mod.set_checkpoint_observer(lambda ev, d: seen.append(
        (ev, {k: v for k, v in d.items() if k not in ("dir", "quarantine")})))
    try:
        for step in range(1, 6):
            mod.save_checkpoint(ckpt_dir, step, state, keep=3)
        writer = mod.AsyncCheckpointer()
        writer.save(ckpt_dir, 6, state)
        writer.save(ckpt_dir, 6, state)
        writer.close(timeout=30)
        with open(os.path.join(ckpt_dir, "step_%012d" % 6,
                               "manifest.json"), "w") as f:
            f.write("{torn")
        _, manifest = mod.restore_latest(ckpt_dir)
        assert manifest["step"] == 5
    finally:
        mod.set_checkpoint_observer(None)
    return seen


def test_checkpoint_observer_sees_the_references_events(tmp_path):
    state = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
             "step": np.asarray(3, np.int32)}
    port = _observed(tckpt, str(tmp_path / "port"), state)
    ref = _observed(jckpt, str(tmp_path / "ref"), state)
    assert port == ref
    assert [e for e, _ in port].count("gc") >= 2
    assert {e for e, _ in port} == {"save", "gc", "duplicate_save_skipped",
                                    "corrupt_skipped", "restore"}


def test_checkpoint_observer_failure_never_breaks_a_save(tmp_path):
    def boom(event, detail):
        raise RuntimeError("observer down")

    tckpt.set_checkpoint_observer(boom)
    try:
        tckpt.save_checkpoint(str(tmp_path), 1, {"w": np.ones(2)})
    finally:
        tckpt.set_checkpoint_observer(None)
    assert tckpt.latest_step(str(tmp_path)) == 1


def test_read_manifest_matches_the_reference(tmp_path):
    d = str(tmp_path)
    tckpt.save_checkpoint(d, 3, {"w": np.ones((2, 2), np.float32)},
                          meta={"epoch": 1})
    assert tckpt.read_manifest(d) == jckpt.read_manifest(d) == \
        tckpt.read_manifest(d, 3)
    os.makedirs(os.path.join(d, "step_%012d" % 4))
    with open(os.path.join(d, "step_%012d" % 4, "manifest.json"), "w") as f:
        f.write("{torn")
    for mod in (tckpt, jckpt):
        with pytest.raises(mod.CorruptCheckpointError):
            mod.read_manifest(d, 4)
    with pytest.raises(FileNotFoundError):
        tckpt.read_manifest(str(tmp_path / "empty"))


def test_async_checkpointer_close_is_a_bounded_join(tmp_path, monkeypatch):
    release = threading.Event()
    real = tckpt.save_checkpoint

    def slow(*a, **k):
        release.wait(10)
        return real(*a, **k)

    monkeypatch.setattr(tckpt, "save_checkpoint", slow)
    writer = tckpt.AsyncCheckpointer()
    writer.save(str(tmp_path), 1, {"w": np.ones(2)})
    with pytest.raises(TimeoutError):
        writer.close(timeout=0.1)
    release.set()
    writer.close(timeout=10)
    assert tckpt.latest_step(str(tmp_path)) == 1


# ---------------------------------------------------------------------------
# a world of four gloo workers, one slowed
# ---------------------------------------------------------------------------

SLOW_RANK = 2


@pytest.fixture(scope="module")
def straggle_world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("straggle"))
    scenarios = [{"name": name, "kind": "straggle", "slow_rank": slow,
                  "sleep": 0.6, "steps": 6, "log_every": 2}
                 for name, slow in (("slowed", SLOW_RANK),
                                    ("uniform", -1))]
    lines = dp_check.launch_workers({"out": out, "scenarios": scenarios},
                                    world=4, timeout=600)
    runs = {}
    for rank_lines in lines:
        for line in rank_lines:
            runs.setdefault(line["scenario"], {})[line["rank"]] = line
    return runs


def test_the_slowed_rank_alone_reports_straggler_events(straggle_world):
    ranks = straggle_world["slowed"]
    assert sorted(ranks) == [0, 1, 2, 3]
    for rank, r in ranks.items():
        assert sorted(r["gang_p50"]) == ["0", "1", "2", "3"]
        if rank == SLOW_RANK:
            assert r["straggler_events"] >= 1
        else:
            assert r["straggler_events"] == 0
        # the peers wait for the slowed rank inside the collectives
        assert r["step_profile"]["collective"]["count"] == 6
        assert _conserves(r["goodput_detail"])
    slow = ranks[SLOW_RANK]["step_profile"]
    peer = ranks[0]["step_profile"]
    assert slow["dispatch"]["p50"] > 2 * peer["dispatch"]["p50"]
    assert peer["collective"]["p50"] > slow["collective"]["p50"]


def test_a_uniform_world_flags_no_one(straggle_world):
    ranks = straggle_world["uniform"]
    assert sorted(ranks) == [0, 1, 2, 3]
    assert all(r["straggler_events"] == 0 for r in ranks.values())
    gangs = [r["gang_p50"] for r in ranks.values()]
    assert all(g == gangs[0] for g in gangs)      # one all-gather
    flops = {r["hardware"]["flops_per_step"] for r in ranks.values()}
    assert len(flops) == 1 and flops.pop() > 0
