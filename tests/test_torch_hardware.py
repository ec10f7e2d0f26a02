"""The port's hardware-efficiency plane (``paddle_operator_tpu_torch/obs/
hardware.py``) against the JAX package's (``tests/test_hardware.py``):
the chip registry with the H100 rows, the step cost counted by
``FlopCounterMode`` (and the flash operators' FLOP formulas), the MFU
clamp and collapse baseline, the self-conserving block under the
reference's own audit, and the runner's block."""

import json
import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from paddle_operator_tpu_torch.models import gpt as tgpt
from paddle_operator_tpu_torch.models import resnet as tres
from paddle_operator_tpu_torch.obs import hardware as thw
from paddle_operator_tpu_torch.ops import attention
from paddle_operator_tpu_torch.ops import optim as topt
from paddle_operator_tpu_torch.parallel import build_train_step
from paddle_operator_tpu_torch.runner import TrainJob, run_training
from paddle_operator_tpu_torch.utils import trace as ttrace

jax = pytest.importorskip("jax")

from paddle_operator_tpu.obs import hardware as jhw  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# chip capability registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,flops,bw", [
    ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12),
    ("NVIDIA H100 PCIe", 756e12, 2.0e12),
    ("NVIDIA H100 NVL", 835e12, 3.9e12),
    ("TPU v5 lite", 197e12, 819e9), ("TPU v4", 275e12, 1228e9),
    ("v5litepod-16", 197e12, 819e9), ("TPU v6e", 918e12, 1640e9),
    ("TPU v3", 123e12, 900e9)])
def test_registry_resolves(kind, flops, bw):
    assert thw.lookup_chip(kind) == (flops, bw)


@pytest.mark.parametrize("kind", ["TPU v5 lite", "TPU v4", "v5litepod-16",
                                  "TPU v6e", "TPU v3", "TPU v2",
                                  "quantum-abacus"])
def test_tpu_rows_are_the_reference_rows(kind):
    assert thw.lookup_chip(kind) == jhw.lookup_chip(kind)


@pytest.mark.parametrize("name,flops,bw", [
    ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12),
    ("NVIDIA H100 PCIe", 756e12, 2.0e12),
    ("NVIDIA H100 NVL", 835e12, 3.9e12)])
def test_cuda_device_resolves_by_its_name(monkeypatch, name, flops, bw):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    chip = thw.resolve_chip(torch.device("cuda", 0))
    assert (chip.device_kind, chip.backend, chip.peak_flops,
            chip.hbm_bandwidth, chip.source) == (name, "gpu", flops, bw,
                                                 "registry")


def test_unknown_card_takes_the_calibrated_then_default_peak(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "Quantum Abacus 9000")
    chip = thw.resolve_chip("cuda", calibrated_flops=3.2e12)
    assert (chip.peak_flops, chip.source, chip.backend) == (
        3.2e12, "calibrated", "gpu")
    chip = thw.resolve_chip("cuda")
    assert (chip.peak_flops, chip.source) == (thw.DEFAULT_CPU_PEAK_FLOPS,
                                              "default")


def test_cpu_takes_the_reference_ladder():
    chip = thw.resolve_chip("cpu")
    assert (chip.device_kind, chip.backend, chip.source, chip.peak_flops) \
        == ("cpu", "cpu", "default", thw.DEFAULT_CPU_PEAK_FLOPS)
    assert thw.resolve_chip("cpu", calibrated_flops=2e12).source == \
        "calibrated"
    assert thw.DEFAULT_CPU_PEAK_FLOPS == jhw.DEFAULT_CPU_PEAK_FLOPS
    assert thw.MFU_COLLAPSE_FLOOR == jhw.MFU_COLLAPSE_FLOOR


def test_ridge_point_and_roofline():
    chip = thw.ChipSpec("x", "gpu", 200e12, 800e9, "registry")
    assert chip.ridge == pytest.approx(250.0)
    assert thw.roofline_class(300.0, chip) == "compute_bound"
    assert thw.roofline_class(100.0, chip) == "memory_bound"
    assert thw.roofline_class(0.0, chip) == "unknown"


# ---------------------------------------------------------------------------
# step cost
# ---------------------------------------------------------------------------

def test_step_cost_counts_a_real_call():
    a = torch.ones(32, 32)
    out, cost = thw.step_cost_of(lambda x, y: (x @ y).sum(), a, a)
    assert float(out) == 32.0 * 32 * 32
    assert cost.source == "flop_counter"
    assert cost.flops == 2 * 32 ** 3
    assert cost.bytes_accessed == 0.0 and cost.arithmetic_intensity == 0.0


def test_fused_window_cost_is_per_optimizer_step():
    a = torch.ones(32, 32)
    _, one = thw.step_cost_of(lambda x: x @ x, a)
    _, k4 = thw.step_cost_of(lambda x: x @ x, a, steps_per_call=4,
                             bytes_per_step=1e3)
    assert k4.flops == pytest.approx(one.flops / 4)
    assert k4.bytes_accessed == 1e3


def test_no_flops_gives_no_cost():
    out, cost = thw.step_cost_of(lambda x: x + 1, torch.ones(4))
    assert cost is None and out.tolist() == [2.0] * 4


def test_analytic_fallback_is_stamped():
    cost = thw.analytic_cost(6e9, 2e8)
    assert cost.source == "analytic"
    assert cost.arithmetic_intensity == pytest.approx(30.0)


def test_step_cost_of_the_train_step_equals_the_counter():
    """The runner's count of a ResNet step is FlopCounterMode's count of
    the same step_fn call, and counting leaves the result unchanged."""
    gen = torch.Generator().manual_seed(0)
    params = tres.init(gen, depth=18, num_classes=10)
    batch = tres.synthetic_batch(gen, 4, 16, 10)
    loss = lambda p, b: tres.loss_fn(p, b, dtype=torch.float32)  # noqa
    opt = topt.sgd(0.01, momentum=0.9)
    fn_a, st_a = build_train_step(loss, opt, params, batch,
                                  merge_stats=tres.merge_stats)
    fn_b, st_b = build_train_step(loss, opt, params, batch,
                                  merge_stats=tres.merge_stats)
    with FlopCounterMode(display=False) as counter:
        st_a, m_a = fn_a(st_a, batch)
    (st_b, m_b), cost = thw.step_cost_of(fn_b, st_b, batch)
    assert cost.flops == counter.get_total_flops() > 0
    assert float(m_a["loss"]) == float(m_b["loss"])


def _linear_no_grad():
    x, w = torch.randn(4, 8), torch.randn(16, 8)
    torch.nn.functional.linear(x, w)


def _flash_causal():
    q = torch.randn(1, 2, 256, 64, requires_grad=True)
    attention.flash_attention(q, q, q, causal=True).sum().backward()


def _conv_backward():
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    torch.nn.functional.conv2d(x, w, padding=1).square().sum().backward()


def _resnet_step():
    gen = torch.Generator().manual_seed(0)
    batch = tres.synthetic_batch(gen, 4, 16, 10)
    fn, state = build_train_step(
        lambda p, b: tres.loss_fn(p, b, dtype=torch.float32),
        topt.sgd(0.01, momentum=0.9), tres.init(gen, depth=18,
                                                num_classes=10),
        batch, merge_stats=tres.merge_stats)
    fn(state, batch)


@pytest.mark.parametrize("work", [_linear_no_grad, _flash_causal,
                                  _conv_backward, _resnet_step],
                         ids=["linear_no_grad", "flash_causal",
                              "conv_backward", "resnet_step"])
def test_step_flop_counter_counts_what_flop_counter_mode_counts(work):
    """The runner's counter gives FlopCounterMode's count, operators
    without a formula counted through their decomposition."""
    with FlopCounterMode(display=False) as reference:
        work()
    with thw.StepFlopCounter() as port:
        work()
    assert port.flops == reference.get_total_flops() > 0


def test_step_flop_counter_starts_without_importing_dynamo():
    """FlopCounterMode's first operator makes a process import
    torch._dynamo (seconds, in every worker); the runner's counter does
    not."""
    import subprocess

    code = ("import sys, torch\n"
            "from paddle_operator_tpu_torch.obs.hardware import "
            "StepFlopCounter\n"
            "x = torch.randn(8, 8)\n"
            "with StepFlopCounter() as c: x @ x\n"
            "assert c.flops == 1024, c.flops\n"
            "sys.exit(1 if 'torch._dynamo' in sys.modules else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without CUDA")
def test_startup_probe_runs_on_the_card_unless_asked(capsys):
    """The probe's default device is the card: without CUDA it refuses
    (argparse's exit 2, nothing on stdout); ``--device cpu`` probes the
    CPU and prints one JSON line of seconds."""
    from paddle_operator_tpu_torch.obs import startup_probe

    with pytest.raises(SystemExit) as exc:
        startup_probe.main([])
    assert exc.value.code == 2
    assert capsys.readouterr().out == ""
    assert startup_probe.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu"
    assert all(out[name + "_s"] > 0 for name in startup_probe.PROBES)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 256, 64), (2, 3, 384, 128)])
def test_flash_operators_report_model_flops(causal, shape):
    """The flash triple's FLOPs reach the counter: forward and backward
    through the operators count 12 D a live pair a head; non-causal, the
    forward is FlopCounterMode's count of its plain version and the three
    together its count of the einsum attention's forward and backward;
    causal keeps the live pairs' share of it."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen).requires_grad_()
               for _ in range(3))
    b, h, s, d = shape
    with FlopCounterMode(display=False) as flash:
        attention.flash_attention(q, k, v, causal=causal).sum().backward()
    with FlopCounterMode(display=False) as fwd_only:
        attention.flash_attention(q.detach(), k.detach(), v.detach(),
                                  causal=causal)
    with FlopCounterMode(display=False) as plain_fwd:
        attention._plain_flash_fwd(q.detach(), k.detach(), v.detach(),
                                   0.125, False)
    qe, ke, ve = (x.detach().requires_grad_() for x in (q, k, v))
    with FlopCounterMode(display=False) as einsum:
        attention._reference_attention(qe, ke, ve, 0.125).sum().backward()
    pairs = attention.attention_pairs(s, causal)
    assert flash.get_total_flops() == 12 * b * h * d * pairs
    assert fwd_only.get_total_flops() == 4 * b * h * d * pairs
    assert plain_fwd.get_total_flops() * pairs == \
        fwd_only.get_total_flops() * s * s
    assert einsum.get_total_flops() * pairs == \
        flash.get_total_flops() * s * s


def test_flash_report_left_out_counts_nothing():
    """Without the operators' formulas the counter cannot see the
    attention: the fault the card's FLOP gate is proven against."""
    from torch.utils.flop_counter import flop_registry

    ops = [getattr(torch.ops.paddle_tpu_torch, "flash_" + k)
           for k in ("fwd", "dq", "dkv")]
    saved = {op: flop_registry.pop(op) for op in ops}
    try:
        q = torch.randn(1, 2, 256, 64, requires_grad=True)
        with FlopCounterMode(display=False) as c:
            attention.flash_attention(q, q, q, causal=True).sum().backward()
        assert c.get_total_flops() == 0
    finally:
        flop_registry.update(saved)


# ---------------------------------------------------------------------------
# MFU clamp + the collapse baseline (the reference's cases, both packages)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("achieved,peak", [(5e11, 1e12), (2e12, 1e12),
                                           (0.0, 1e12), (1e12, 0.0)])
def test_clamped_mfu_matches_the_reference(achieved, peak):
    assert thw.clamped_mfu(achieved, peak) == jhw.clamped_mfu(achieved, peak)


@pytest.mark.parametrize("samples", [
    [2e-5],
    [0.4] * 4 + [2e-5] + [2e-5] * 20 + [0.39],
    [0.4] * 4 + [0.05],
    [1e-5, 2e-3],
    [0.3, 0.31, 0.29, 0.3, 0.01, 0.02, 0.2, 0.3]])
def test_mfu_baseline_matches_the_reference(samples):
    port, ref = thw.MfuBaseline(), jhw.MfuBaseline()
    for v in samples:
        assert port.observe(v) == ref.observe(v)
        assert port.degraded == ref.degraded
    assert port.baseline == ref.baseline


# ---------------------------------------------------------------------------
# the plane and its block
# ---------------------------------------------------------------------------

def _chip():
    return thw.ChipSpec("NVIDIA H100 80GB HBM3", "gpu", 989e12, 3.35e12,
                        "registry")


@pytest.mark.parametrize("cost,records", [
    ((7.5e13, 2.5e11), [(10, 10.0), (5, 5.0)]),
    ((1e12, 0.0), [(4, 2.0)]),
    ((1e9, 0.0), [(100, 1e-9)]),          # overdriven: clamped
    (None, [(10, 1.0)])])                 # unavailable: MFU suppressed
def test_block_matches_the_reference_block(cost, records):
    """The same chip, cost and records give the reference's block, key for
    key; both audits accept it."""
    chip = _chip()
    port = thw.HardwarePlane(chip, thw.analytic_cost(*cost) if cost
                             else None)
    ref = jhw.HardwarePlane(
        jhw.ChipSpec(*[getattr(chip, f) for f in (
            "device_kind", "backend", "peak_flops", "hbm_bandwidth",
            "source")]),
        jhw.analytic_cost(*cost) if cost else None)
    for steps, secs in records:
        port.record(steps, secs)
        ref.record(steps, secs)
    assert port.block() == ref.block()
    assert thw.conservation_violations(port.block()) == []
    assert jhw.conservation_violations(port.block()) == []
    assert port.mfu_of_rate(3.0) == ref.mfu_of_rate(3.0)


@pytest.mark.parametrize("audit", [thw.conservation_violations,
                                   jhw.conservation_violations],
                         ids=["port", "reference"])
def test_tampered_block_is_caught(audit):
    plane = thw.HardwarePlane(_chip(), thw.analytic_cost(1e12))
    plane.record(4, 2.0)
    blk = plane.block()
    assert audit(blk) == []
    assert any("does not conserve" in e for e in audit(
        dict(blk, total_flops=blk["total_flops"] * 2)))
    assert any("not derivable" in e for e in audit(dict(blk, mfu=0.9)))
    assert any("outside [0, 1]" in e for e in audit(dict(blk, mfu=1.5)))


def test_emit_trace_block_rebuilds_offline(tmp_path, monkeypatch):
    """The port's hardware_block trace event is rebuilt by the reference's
    offline report."""
    path = str(tmp_path / "t.jsonl")
    monkeypatch.setattr(ttrace, "_global", ttrace.Tracer(path=path))
    plane = thw.HardwarePlane(_chip(), thw.analytic_cost(7.5e13))
    plane.record(3, 3.0)
    plane.emit_trace(job="d/j")
    ttrace.tracer().close()
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    from obs_report import hardware_lane, load_trace

    rc, text = hardware_lane(load_trace(path))
    assert rc == 0, text
    assert "hardware conservation: ok" in text and "d/j" in text


def test_device_memory_stats_absent_degrades():
    assert thw.device_memory_stats() == {}
    assert thw.device_memory_stats("cpu") == {}
    assert thw.HardwarePlane(_chip(), device="cpu").sample_hbm() == {}


def test_step_clock_banks_host_seconds_on_the_cpu():
    plane = thw.HardwarePlane(_chip(), thw.analytic_cost(1e9))
    clock = thw.StepClock(plane, "cpu")
    t = clock.begin()
    clock.end(t, 3)
    clock.drain(wait=True)
    blk = plane.block()
    assert blk["steps"] == 3 and blk["step_seconds"] >= 0.0


# ---------------------------------------------------------------------------
# the runner's block
# ---------------------------------------------------------------------------

def _job(**kw):
    """A tiny GPT (``TINY_CONFIG``, 8 x 16 tokens, adamw) on the CPU."""
    return TrainJob(
        init_params=lambda gen: tgpt.init(gen, tgpt.TINY_CONFIG),
        loss_fn=lambda p, b: tgpt.loss_fn(p, b, dtype=torch.float32),
        optimizer=topt.adamw(1e-3),
        make_batch=lambda gen, step: tgpt.synthetic_batch(gen, 8, 16, 1024),
        total_steps=3, log_every=1, device="cpu", **kw)


@pytest.fixture(scope="module")
def counted_run():
    return run_training(_job())


def test_runner_hardware_block_self_conserving(counted_run):
    blk = counted_run["hardware"]
    assert blk["cost_source"] == "flop_counter"
    assert blk["steps"] == 3 and blk["flops_per_step"] > 0
    assert blk["bytes_per_step"] == 0.0 and blk["roofline"] == "unknown"
    assert blk["device_kind"] == "cpu" and blk["peak_source"] == "default"
    assert thw.conservation_violations(blk) == []
    assert jhw.conservation_violations(blk) == []
    json.dumps(blk)


def test_runner_flops_are_the_counter_count_of_one_step(counted_run):
    gen = torch.Generator().manual_seed(0)
    job = _job()
    batch = job.make_batch(gen, 0)
    fn, state = build_train_step(job.loss_fn, job.optimizer,
                                 job.init_params(gen), batch)
    with FlopCounterMode(display=False) as counter:
        fn(state, batch)
    assert counted_run["hardware"]["flops_per_step"] == \
        counter.get_total_flops()


def test_runner_window_cost_is_per_step(counted_run):
    out = run_training(_job(steps_per_call=2))
    assert out["hardware"]["flops_per_step"] == \
        counted_run["hardware"]["flops_per_step"]
    assert out["hardware"]["steps"] == 3


def test_runner_analytic_fallback_when_the_count_is_empty(monkeypatch):
    import paddle_operator_tpu_torch.runner as runner_mod

    monkeypatch.setattr(runner_mod, "step_cost_of",
                        lambda fn, *a, **k: (fn(*a), None))
    out = runner_mod.run_training(_job(flops_per_step=5e9,
                                       bytes_per_step=1e9))
    blk = out["hardware"]
    assert (blk["cost_source"], blk["flops_per_step"],
            blk["bytes_per_step"]) == ("analytic", 5e9, 1e9)
    assert blk["arithmetic_intensity"] == pytest.approx(5.0)
    assert thw.conservation_violations(blk) == []


def test_runner_suppresses_mfu_with_no_cost(monkeypatch):
    import paddle_operator_tpu_torch.runner as runner_mod

    monkeypatch.setattr(runner_mod, "step_cost_of",
                        lambda fn, *a, **k: (fn(*a), None))
    out = runner_mod.run_training(_job())
    assert out["hardware"]["mfu"] is None
    assert out["hardware"]["cost_source"] == "unavailable"


def test_the_port_imports_no_jax():
    """The hardware plane, like every port module, imports with torch
    alone."""
    import subprocess

    code = ("import sys; import paddle_operator_tpu_torch.obs, "
            "paddle_operator_tpu_torch.runner, "
            "paddle_operator_tpu_torch.utils.trace; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_operator_tpu.'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
