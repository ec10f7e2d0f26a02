"""The port's tracing (``paddle_operator_tpu_torch/utils/trace.py``)
against the JAX package's: the JSON-lines span recorder, the incident
span context (encoded in one package, decoded in the other), the
``torch.profiler`` step window (the reference's window rules, its
``jax.profiler`` replaced by a fake on both sides), and the runner's
``train_step`` events, mirroring ``tests/test_trace.py``."""

import json
import os

import pytest
import torch

from paddle_operator_tpu_torch.models import gpt as tgpt
from paddle_operator_tpu_torch.ops import optim as topt
from paddle_operator_tpu_torch.runner import TrainJob, run_training
from paddle_operator_tpu_torch.utils import trace as ttrace

jax = pytest.importorskip("jax")

from paddle_operator_tpu.utils import trace as jtrace  # noqa: E402


def _records(path):
    return [json.loads(line) for line in open(path)]


def _tiny_job(total=3, **kw):
    """A tiny GPT (``TINY_CONFIG``, 8 x 16 tokens, adamw) on the CPU."""
    return TrainJob(
        init_params=lambda gen: tgpt.init(gen, tgpt.TINY_CONFIG),
        loss_fn=lambda p, b: tgpt.loss_fn(p, b, dtype=torch.float32),
        optimizer=topt.adamw(1e-3),
        make_batch=lambda gen, step: tgpt.synthetic_batch(gen, 8, 16, 1024),
        total_steps=total, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the span recorder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [ttrace, jtrace], ids=["port", "reference"])
def test_span_nesting_and_jsonl(tmp_path, mod):
    path = str(tmp_path / "trace.jsonl")
    t = mod.Tracer(path=path)
    with t.span("outer", job="j1"):
        with t.span("inner"):
            pass
        t.event("marker", step=3)
    t.close()
    recs = _records(path)
    by_name = {r["name"]: r for r in recs}
    assert [r["name"] for r in recs] == ["clock_anchor", "inner",
                                         "marker", "outer"]
    assert by_name["outer"]["depth"] == 0 and by_name["inner"]["depth"] == 1
    assert by_name["marker"]["attrs"] == {"step": 3}
    assert by_name["outer"]["attrs"] == {"job": "j1"}
    assert by_name["outer"]["dur_ms"] >= by_name["inner"]["dur_ms"]
    assert all(set(r) == {"name", "t0", "m0", "dur_ms", "depth", "attrs"}
               for r in recs)


def test_port_and_reference_write_the_same_records(tmp_path):
    """The same spans and events give the same records, field for field
    (times aside)."""
    def names_and_attrs(mod, name):
        t = mod.Tracer(path=str(tmp_path / name))
        with t.span("a", x=1) as sp:
            sp.set(outcome="ok")
            t.event("b", y=[1, 2])
        t.close()
        return [(r["name"], r["depth"], r["attrs"])
                for r in _records(str(tmp_path / name))
                if r["name"] != "clock_anchor"]

    assert names_and_attrs(ttrace, "p.jsonl") == \
        names_and_attrs(jtrace, "r.jsonl")


def test_disabled_tracer_is_noop():
    t = ttrace.Tracer(path="", enabled=False)
    with t.span("x") as sp:
        sp.set(a=1)
        t.event("y")
    assert t.events == []


@pytest.mark.parametrize("mod", [ttrace, jtrace], ids=["port", "reference"])
def test_rotation_keeps_segments_each_anchored(tmp_path, mod):
    path = str(tmp_path / "r.jsonl")
    t = mod.Tracer(path=path, max_bytes=400, keep=2)
    for i in range(40):
        t.event("e", i=i)
    t.close()
    assert os.path.exists(path + ".1") and os.path.exists(path + ".2")
    assert not os.path.exists(path + ".3")
    for seg in (path, path + ".1", path + ".2"):
        recs = _records(seg)
        if recs:
            assert recs[0]["name"] == "clock_anchor"


def test_worker_trace_path(monkeypatch):
    monkeypatch.delenv("TPUJOB_NUM_WORKERS", raising=False)
    assert ttrace.worker_trace_path("/t/run.jsonl") == "/t/run.jsonl"
    monkeypatch.setenv("TPUJOB_NUM_WORKERS", "4")
    monkeypatch.setenv("TPUJOB_WORKER_ID", "2")
    assert ttrace.worker_trace_path("/t/run.jsonl") == "/t/run.jsonl.w2"
    assert ttrace.worker_trace_path("") == ""


# ---------------------------------------------------------------------------
# the incident span context
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [(ttrace, jtrace), (jtrace, ttrace)],
                         ids=["port_to_reference", "reference_to_port"])
@pytest.mark.parametrize("fields", [("inc-7", "preemption", "default/j"),
                                    ("inc-8", "", ""),
                                    ("inc-9", "drain", "ns/name-x")])
def test_span_context_crosses_packages(src, dst, fields):
    text = src.SpanContext(*fields).encode()
    got = dst.SpanContext.decode(text)
    assert (got.incident_id, got.cause, got.job) == fields
    assert got.encode() == text


@pytest.mark.parametrize("text", ["", None, "v2;a;b;c", "v1;;c;j",
                                  "v1;a;b", "garbage"])
def test_span_context_decode_refuses_what_the_reference_refuses(text):
    assert ttrace.SpanContext.decode(text) is None
    assert jtrace.SpanContext.decode(text) is None


def test_incident_context_stamps_records(tmp_path):
    t = ttrace.Tracer(path=str(tmp_path / "i.jsonl"))
    ttrace.set_incident_context(ttrace.SpanContext("inc-1", "drain", "d/j"))
    try:
        t.event("a")
        t.event("b", incident="explicit")
        assert ttrace.current_incident_context().incident_id == "inc-1"
    finally:
        ttrace.clear_incident_context()
    t.event("c")
    t.close()
    recs = {r["name"]: r["attrs"] for r in _records(str(tmp_path / "i.jsonl"))}
    assert recs["a"]["incident"] == "inc-1"
    assert recs["b"]["incident"] == "explicit"
    assert "incident" not in recs["c"]
    assert ttrace.current_incident_context() is None


# ---------------------------------------------------------------------------
# the profiler window
# ---------------------------------------------------------------------------

class _Calls:
    """Records what the window does: the port's torch.profiler faked,
    the reference's jax.profiler faked, into one list each."""

    def __init__(self, monkeypatch):
        self.port, self.ref = [], []
        calls = self

        class FakeProfile:
            def __init__(self, activities=()):
                self.activities = activities

            def start(self):
                calls.port.append("start")

            def stop(self):
                calls.port.append("stop")

            def export_chrome_trace(self, path):
                calls.port.append(("export", os.path.basename(path)))

        class FakeJaxProfiler:
            @staticmethod
            def start_trace(d):
                calls.ref.append("start")

            @staticmethod
            def stop_trace():
                calls.ref.append("stop")

        monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
        monkeypatch.setattr(jax, "profiler", FakeJaxProfiler)

    def starts_stops(self):
        return [c for c in self.port if isinstance(c, str)]


@pytest.mark.parametrize("window,span,steps", [
    ("2:4", 1, 6), ("10:13", 1, 20), ("10:12", 25, 1), ("0:1", 1, 3),
    ("10:12", 5, 4), ("3:9", 4, 3)])
def test_profile_window_matches_the_reference(tmp_path, monkeypatch, window,
                                              span, steps):
    """The window opens and closes at the reference's steps, for per-step
    calls and fused spans alike; each window writes one trace."""
    calls = _Calls(monkeypatch)
    port = ttrace.profile_steps(profile_dir=str(tmp_path), window=window)
    ref = jtrace.profile_steps(profile_dir=str(tmp_path), window=window)
    for i in range(steps):
        for p in (port, ref):
            p.before(i * span, span=span)
            p.after(i * span, span=span)
    port.close()
    ref.close()
    assert calls.starts_stops() == calls.ref
    assert len(port.traces) == calls.ref.count("stop")


def test_profile_window_intersects_fused_span(tmp_path, monkeypatch):
    calls = _Calls(monkeypatch)
    p = ttrace.profile_steps(profile_dir=str(tmp_path), window="10:12")
    p.before(0, span=25)
    assert calls.port == ["start"]
    p.after(0, span=25)
    assert calls.port[1:] == ["stop", ("export",
                                       "steps_0-25.pid%d.trace.json"
                                       % os.getpid())]
    calls.port.clear()
    p2 = ttrace.profile_steps(profile_dir=str(tmp_path), window="10:12")
    p2.before(0, span=5)
    assert calls.port == []
    p2.before(10)
    p2.after(10)
    assert calls.port == ["start"]     # 11 < stop: still profiling
    p2.after(11)
    assert calls.port[-2] == "stop"


def test_profile_steps_disabled_without_dir(monkeypatch):
    monkeypatch.delenv("TPUJOB_PROFILE_DIR", raising=False)

    def boom(*a, **k):
        raise AssertionError("the profiler must not start")

    monkeypatch.setattr(torch.profiler, "profile", boom)
    prof = ttrace.profile_steps(profile_dir="")
    for step in range(20):
        prof.before(step)
        prof.after(step)
    prof.close()
    assert prof.traces == []


@pytest.mark.parametrize("window", ["", "a:b", "7"])
def test_profile_window_default_and_unparseable(window, monkeypatch):
    monkeypatch.delenv("TPUJOB_PROFILE_STEPS", raising=False)
    p = ttrace.profile_steps(profile_dir="x", window=window or None)
    assert (p.start, p.stop) == (10, 13)


def test_runner_profile_window_writes_a_chrome_trace(tmp_path, monkeypatch):
    """A real torch.profiler window of the runner on the CPU: one Chrome
    trace of steps 1-2 whose events name the step's operators."""
    monkeypatch.setenv("TPUJOB_PROFILE_DIR", str(tmp_path / "prof"))
    monkeypatch.setenv("TPUJOB_PROFILE_STEPS", "1:3")
    run_training(_tiny_job(total=4))
    files = os.listdir(tmp_path / "prof")
    assert files == ["steps_1-3.pid%d.trace.json" % os.getpid()]
    with open(tmp_path / "prof" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name", "")) for e in events)


# ---------------------------------------------------------------------------
# the runner's trace events
# ---------------------------------------------------------------------------

def test_runner_emits_step_events(monkeypatch, tmp_path):
    """run_training emits one train_step event per step when tracing is on,
    as the reference's runner does."""
    path = str(tmp_path / "run.jsonl")
    monkeypatch.setattr(ttrace, "_global", ttrace.Tracer(path=path))
    run_training(_tiny_job(total=3, log_every=0))
    ttrace.tracer().close()
    recs = _records(path)
    assert [r["attrs"]["step"] for r in recs
            if r["name"] == "train_step"] == [1, 2, 3]
    assert [r["name"] for r in recs if r["name"] == "hardware_block"] == \
        ["hardware_block"]


def test_runner_step_profile_events_at_log_boundaries(monkeypatch, tmp_path):
    path = str(tmp_path / "run.jsonl")
    monkeypatch.setattr(ttrace, "_global", ttrace.Tracer(path=path))
    run_training(_tiny_job(total=4, log_every=2))
    ttrace.tracer().close()
    prof = [r["attrs"] for r in _records(path) if r["name"] == "step_profile"]
    assert [p["step"] for p in prof] == [2, 4]
    assert all({"dispatch", "data_wait"} <= set(p) for p in prof)
