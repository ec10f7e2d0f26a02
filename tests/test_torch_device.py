"""The port's device helpers (``paddle_operator_tpu_torch.device``): where
an entry point runs, and the deterministic-algorithms switch the card
runs set in every worker process."""

import json
import os
import subprocess
import sys

import pytest
import torch

from paddle_operator_tpu_torch.device import deterministic_algorithms, \
    resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="runs on CUDA"):
        resolve_device(None)


@pytest.mark.parametrize("mode", [True, False])
def test_deterministic_switch_sets_torchs_flag(mode):
    saved = torch.are_deterministic_algorithms_enabled()
    try:
        deterministic_algorithms(not mode)
        deterministic_algorithms(mode)
        assert torch.are_deterministic_algorithms_enabled() is mode
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
    finally:
        deterministic_algorithms(saved)


def test_deterministic_switch_matches_torchs_own():
    """The same flags as ``torch.use_deterministic_algorithms``."""
    saved = torch.are_deterministic_algorithms_enabled()
    try:
        for mode in (True, False):
            torch.use_deterministic_algorithms(mode)
            want = (torch.are_deterministic_algorithms_enabled(),
                    torch.is_deterministic_algorithms_warn_only_enabled())
            deterministic_algorithms(not mode)
            deterministic_algorithms(mode)
            assert (torch.are_deterministic_algorithms_enabled(),
                    torch.is_deterministic_algorithms_warn_only_enabled()) \
                == want
    finally:
        torch.use_deterministic_algorithms(saved)


def test_deterministic_switch_imports_no_compiler():
    """A fresh process that sets the switch loads neither inductor nor
    dynamo (``torch.use_deterministic_algorithms`` loads both)."""
    code = ("import sys, torch\n"
            "from paddle_operator_tpu_torch.device import "
            "deterministic_algorithms\n"
            "deterministic_algorithms(True)\n"
            "assert torch.are_deterministic_algorithms_enabled()\n"
            "print(sorted(m for m in ('torch._dynamo', 'torch._inductor',"
            " 'torch._inductor.config') if m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_deterministic_switch_sets_inductors_flag_once_loaded():
    import torch._inductor.config as inductor_config

    saved = (torch.are_deterministic_algorithms_enabled(),
             inductor_config.deterministic)
    try:
        for mode in (True, False):
            deterministic_algorithms(mode)
            assert inductor_config.deterministic is mode
    finally:
        deterministic_algorithms(saved[0])
        inductor_config.deterministic = saved[1]


@pytest.mark.skipif(torch.cuda.is_available(), reason="probes the CPU")
def test_startup_probe_with_a_bytecode_cache(tmp_path, capsys):
    """``--pycache`` probes again with the bytecode kept in the directory
    given: it fills it, and the port's switch stays far below torch's."""
    from paddle_operator_tpu_torch.obs import startup_probe

    assert startup_probe.main(["--device", "cpu", "--pycache",
                               str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out)
    for got in (out, out["pycache"]):
        assert all(got[name + "_s"] > 0 for name in startup_probe.PROBES)
        assert got["deterministic_algorithms_s"] \
            < got["use_deterministic_algorithms_s"]
    assert any(f.endswith(".pyc") for _, _, fs in os.walk(tmp_path)
               for f in fs)
