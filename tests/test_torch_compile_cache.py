"""The port's compile cache on the CPU (``paddle_operator_tpu_torch.
compile_cache``): the step fingerprint, the kernel-library ladder (memo,
local, fleet, built) with a fake builder and loader in place of nvcc and
dlopen, the library key by toolchain and device, the first-use check,
the step-cost rung of ``run_training``, and the parts held against the
JAX package's ``compile_cache``.

No test waits on nvcc: ``_kernels.build`` is replaced by a builder that
writes a JSON file naming the source's exported symbols, and the loader
by one that reads it back as a library whose functions return the
file's error code.
"""

import functools
import json
import math
import os
import re
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_operator_tpu import compile_cache as ref_cc
from paddle_operator_tpu.obs import parse_exposition
from paddle_operator_tpu_torch import artifacts, compile_cache as cc
from paddle_operator_tpu_torch import runner as trunner
from paddle_operator_tpu_torch.artifacts.store import ArtifactStore
from paddle_operator_tpu_torch.models import gpt as tgpt
from paddle_operator_tpu_torch.ops import _kernels
from paddle_operator_tpu_torch.ops import optim as topt
from paddle_operator_tpu_torch.parallel.mesh import Mesh
from paddle_operator_tpu_torch.runner import TrainJob, run_training

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

H100 = {"nvcc": "Cuda compilation tools, release 12.4, V12.4.131",
        "driver": "12040", "torch": "2.5.1", "torch_cuda": "12.4",
        "device": "NVIDIA H100 80GB HBM3", "capability": "9.0"}


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "compile")
    monkeypatch.setenv("TPUJOB_COMPILE_CACHE_DIR", d)
    for var in ("TPUJOB_ARTIFACT_STORE", "TPUJOB_ARTIFACT_URL",
                "TPUJOB_COMPILE_CACHE"):
        monkeypatch.delenv(var, raising=False)
    cc.reset_stats_for_tests()
    artifacts.reset_for_tests()
    yield d
    cc.reset_stats_for_tests()
    artifacts.reset_for_tests()


def exported(name):
    """The ``extern "C"`` entry points of ``csrc/<name>.cu``."""
    text = _kernels.source(name).read_text()
    return sorted(re.findall(r'extern "C" int (\w+)\(', text))


class FakeFn:
    def __init__(self, lib, sym):
        self.lib, self.sym = lib, sym
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.lib.calls.append(self.sym)
        return self.lib.err


class FakeCDLL:
    """A library file written by :class:`FakeBuilder`: its symbols return
    the file's ``err``."""

    def __init__(self, path):
        try:
            with open(path) as fh:
                spec = json.load(fh)
        except ValueError as e:
            raise OSError("%s: invalid ELF header (%s)" % (path, e))
        self.name, self.symbols = spec["name"], spec["symbols"]
        self.err = spec.get("err", 0)
        self.calls = []

    def __getattr__(self, sym):
        if sym.startswith("_") or sym not in self.symbols:
            raise AttributeError("undefined symbol: %s" % sym)
        return FakeFn(self, sym)


class FakeBuilder:
    """``_kernels.build`` without nvcc: a deterministic file a library,
    each build logged; ``fail`` makes it raise as nvcc's refusal does."""

    def __init__(self):
        self.built = []
        self.fail = False

    def __call__(self, name, path):
        if self.fail:
            raise _kernels.KernelBuildError("kernel build failed: planted")
        self.built.append(name)
        os.makedirs(os.path.dirname(str(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump({"name": name, "symbols": exported(name)}, fh,
                      sort_keys=True)
        return 0.125


@pytest.fixture
def fake(cache_dir, monkeypatch):
    builder = FakeBuilder()
    monkeypatch.setattr(_kernels, "build", builder)
    monkeypatch.setattr(cc, "_open_cdll", FakeCDLL)
    monkeypatch.setattr(cc, "toolchain_and_device", lambda: dict(H100))
    return builder


def _restart():
    """A new process, as far as the ladder can tell: nothing loaded."""
    cc.reset_stats_for_tests()
    artifacts.reset_for_tests()


# ---------------------------------------------------------------------------
# the step fingerprint (the reference's TestFingerprint)
# ---------------------------------------------------------------------------

def _mlp_loss(params, batch):
    h = torch.tanh(batch["x"] @ params["w1"])
    return ((h @ params["w2"] - batch["y"]) ** 2).mean(), {}


def _mlp_setup(seed=0, rows=8):
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    return ({"w1": t(16, 32), "w2": t(32, 4)},
            {"x": t(rows, 16), "y": t(rows, 4)})


def _sgd_step(lr):
    def step(params, batch):
        return {k: v - lr * v for k, v in params.items()}
    return step


class _Scaled:
    """A loss as a bound method: its object's setting is part of it."""

    def __init__(self, scale):
        self.scale = scale

    def loss(self, params, batch):
        loss, aux = _mlp_loss(params, batch)
        return loss * self.scale, aux


class TestStepFingerprint:
    def test_stable_within_process(self, cache_dir):
        p, b = _mlp_setup()
        assert cc.step_fingerprint(_mlp_loss, (p, b)) == \
            cc.step_fingerprint(_mlp_loss, (p, b))

    def test_values_do_not_change_the_key(self, cache_dir):
        p1, b1 = _mlp_setup(seed=0)
        p2, b2 = _mlp_setup(seed=7)
        assert cc.step_fingerprint(_mlp_loss, (p1, b1)) == \
            cc.step_fingerprint(_mlp_loss, (p2, b2))

    def test_shape_changes_the_key(self, cache_dir):
        p, b = _mlp_setup()
        _, b16 = _mlp_setup(rows=16)
        assert cc.step_fingerprint(_mlp_loss, (p, b)) != \
            cc.step_fingerprint(_mlp_loss, (p, b16))

    def test_closure_hyperparameter_changes_the_key(self, cache_dir):
        p, b = _mlp_setup()
        assert cc.step_fingerprint(_sgd_step(0.1), (p, b)) != \
            cc.step_fingerprint(_sgd_step(0.2), (p, b))

    def test_steps_a_call_and_mesh_change_the_key(self, cache_dir):
        p, b = _mlp_setup()
        base = cc.step_fingerprint(_mlp_loss, (p, b), config=1)
        assert base != cc.step_fingerprint(_mlp_loss, (p, b), config=4)
        assert base != cc.step_fingerprint(_mlp_loss, (p, b), config=1,
                                           mesh=Mesh(shape={"dp": 2}))
        assert cc.step_fingerprint(
            _mlp_loss, (p, b), mesh=Mesh(shape={"dp": 2})) != \
            cc.step_fingerprint(_mlp_loss, (p, b),
                                mesh=Mesh(shape={"dp": 1, "tp": 2}))

    def test_optimizers_of_equal_settings_share_a_key(self, cache_dir):
        """Two optimizer objects made alike (a restart makes its own) give
        one key; another momentum gives another."""
        p, b = _mlp_setup()
        key = lambda opt: cc.step_fingerprint(  # noqa: E731
            lambda pp, bb: opt.update(pp, {}, pp), (p, b))
        sched = lambda: topt.cosine_schedule(0.4, 30, 1)  # noqa: E731
        assert key(topt.fused_sgd(sched(), momentum=0.9)) == \
            key(topt.fused_sgd(sched(), momentum=0.9))
        assert key(topt.fused_sgd(sched(), momentum=0.9)) != \
            key(topt.fused_sgd(sched(), momentum=0.8))

    def test_a_bound_methods_object_is_in_the_key(self, cache_dir):
        p, b = _mlp_setup()
        key = lambda fn: cc.step_fingerprint(fn, (p, b))  # noqa: E731
        assert key(_Scaled(1.0).loss) == key(_Scaled(1.0).loss)
        assert key(_Scaled(1.0).loss) != key(_Scaled(2.0).loss)

    def test_the_moe_switch_changes_the_key(self, cache_dir, monkeypatch):
        """TPUJOB_MOE_FUSED is read when a step runs, not when it is
        built: the dense MoE path counts FLOPs that the kernels report
        none of, so the two paths are two keys."""
        p, b = _mlp_setup()
        monkeypatch.setenv("TPUJOB_MOE_FUSED", "1")
        fused = cc.step_fingerprint(_mlp_loss, (p, b))
        monkeypatch.setenv("TPUJOB_MOE_FUSED", "0")
        assert cc.step_fingerprint(_mlp_loss, (p, b)) != fused
        monkeypatch.setenv("TPUJOB_MOE_FUSED", "1")
        assert cc.step_fingerprint(_mlp_loss, (p, b)) == fused

    @pytest.mark.parametrize("module,attr,other", [
        ("moe", "_launch_dispatch", "_plain_dispatch"),
        ("moe", "_launch_combine", "_plain_combine"),
        ("attention", "_launch_dq", "_plain_flash_dq"),
        ("optim", "_launch", "_plain_multi_tensor_sgd")])
    def test_a_swapped_launcher_changes_the_key(self, cache_dir, monkeypatch,
                                                module, attr, other):
        """A plain version put in a kernel's launcher's place (as a check
        of the kernels does) is another step."""
        import importlib

        mod = importlib.import_module("paddle_operator_tpu_torch.ops."
                                      + module)
        p, b = _mlp_setup()
        base = cc.step_fingerprint(_mlp_loss, (p, b))
        launcher = getattr(mod, attr)
        monkeypatch.setattr(mod, attr, getattr(mod, other))
        assert cc.step_fingerprint(_mlp_loss, (p, b)) != base
        monkeypatch.setattr(mod, attr, launcher)
        assert cc.step_fingerprint(_mlp_loss, (p, b)) == base

    def test_stable_across_processes(self, cache_dir):
        """The key a fresh process computes for the same step (other
        values, the same shapes) is this process's."""
        snippet = (
            "import sys; sys.path.insert(0, %r)\n"
            "from paddle_operator_tpu_torch import compile_cache as cc\n"
            "from tests.test_torch_compile_cache import _mlp_loss, "
            "_mlp_setup\n"
            "p, b = _mlp_setup(seed=int(sys.argv[1]))\n"
            "print(cc.step_fingerprint(_mlp_loss, (p, b), config=2))\n"
            % REPO)
        outs = []
        for seed in ("0", "5"):
            out = subprocess.run(
                [sys.executable, "-c", snippet, seed], check=True,
                capture_output=True, text=True, cwd=REPO,
                timeout=240).stdout.strip()
            outs.append(out.splitlines()[-1])
        assert outs[0] == outs[1]
        assert len(outs[0]) == 32


# ---------------------------------------------------------------------------
# the library key: every toolchain and device field
# ---------------------------------------------------------------------------

class TestLibraryFingerprint:
    @pytest.mark.parametrize("field,value", [
        ("nvcc", "Cuda compilation tools, release 12.6, V12.6.77"),
        ("driver", "12060"), ("torch", "2.6.0"), ("torch_cuda", "12.6"),
        ("device", "NVIDIA A100-SXM4-80GB"), ("capability", "8.0")])
    def test_each_field_changes_the_key(self, cache_dir, monkeypatch,
                                        field, value):
        monkeypatch.setattr(cc, "toolchain_and_device", lambda: dict(H100))
        base = cc.library_fingerprint("fused_sgd")
        monkeypatch.setattr(cc, "toolchain_and_device",
                            lambda: dict(H100, **{field: value}))
        assert cc.library_fingerprint("fused_sgd") != base

    def test_two_fake_devices_give_two_keys(self, cache_dir, monkeypatch):
        """The clean seed's fault in the reference: one key for two device
        layouts. Two cards give two keys for every library."""
        keys = {}
        for dev, cap in (("NVIDIA H100 80GB HBM3", "9.0"),
                         ("NVIDIA H100 PCIe", "9.0"),
                         ("NVIDIA A100-SXM4-80GB", "8.0")):
            monkeypatch.setattr(cc, "toolchain_and_device",
                                lambda: dict(H100, device=dev,
                                             capability=cap))
            keys[dev] = [cc.library_fingerprint(n)
                         for n in ("fused_sgd", "moe")]
        flat = [k for ks in keys.values() for k in ks]
        assert len(set(flat)) == len(flat)

    def test_flags_source_and_name_change_the_key(self, cache_dir,
                                                  monkeypatch, tmp_path):
        monkeypatch.setattr(cc, "toolchain_and_device", lambda: dict(H100))
        base = cc.library_fingerprint("fused_sgd")
        assert cc.library_fingerprint("moe") != base
        monkeypatch.setattr(_kernels, "NVCC_FLAGS",
                            _kernels.NVCC_FLAGS + ("-lineinfo",))
        assert cc.library_fingerprint("fused_sgd") != base
        monkeypatch.undo()
        monkeypatch.setattr(cc, "toolchain_and_device", lambda: dict(H100))
        edited = tmp_path / "fused_sgd.cu"
        edited.write_bytes(_kernels.source("fused_sgd").read_bytes()
                           + b"\n// edited\n")
        monkeypatch.setattr(_kernels, "source", lambda name: edited)
        assert cc.library_fingerprint("fused_sgd") != base

    def test_the_key_is_stable(self, cache_dir, monkeypatch):
        monkeypatch.setattr(cc, "toolchain_and_device", lambda: dict(H100))
        key = cc.library_fingerprint("flash_attention")
        assert key == cc.library_fingerprint("flash_attention")
        assert len(key) == 32 and int(key, 16) >= 0

    def test_the_real_reader_names_every_field(self):
        fields = cc.toolchain_and_device()
        assert set(fields) == set(H100)
        assert fields["torch"] == torch.__version__


# ---------------------------------------------------------------------------
# the ladder (the reference's TestCachedJit)
# ---------------------------------------------------------------------------

class TestLadder:
    def test_cold_build_then_memo_hit(self, fake):
        lib = cc.load_library("fused_sgd")
        assert lib.rung == "built" and fake.built == ["fused_sgd"]
        assert cc.stats()["builds"] == 1
        assert cc.stats()["compile_seconds"] > 0
        # a launch's load is no lookup: it counts no hit
        assert _kernels.load("fused_sgd") is lib
        assert cc.stats()["memo_hits"] == 0
        assert cc.load_library("fused_sgd") is lib
        assert cc.stats()["memo_hits"] == 1 and fake.built == ["fused_sgd"]
        assert lib.fused_sgd_f32() == 0

    def test_local_hit_after_a_restart(self, fake, cache_dir):
        cc.load_library("moe")
        path = os.path.join(cache_dir, "moe-%s.so"
                            % cc.library_fingerprint("moe"))
        assert os.path.exists(path)
        _restart()
        lib = cc.load_library("moe")
        assert lib.rung == "local" and fake.built == ["moe"]
        s = cc.stats()
        assert s["local_hits"] == 1 and s["compile_seconds"] == 0.0
        assert cc.libraries()["moe"]["compile_s"] == 0.0

    def test_several_libraries_at_once(self, fake):
        libs = cc.load_libraries(["fused_sgd", "moe", "paged_decode"])
        assert {n: l.rung for n, l in libs.items()} == dict.fromkeys(
            ("fused_sgd", "moe", "paged_decode"), "built")
        assert sorted(fake.built) == ["fused_sgd", "moe", "paged_decode"]

    def test_parallel_builds_count_their_wall_time_once(self, fake,
                                                         monkeypatch):
        """Two builds in flight at once (a barrier holds each until both
        run): ``compile_seconds`` is the wall time of either, not the
        sum of the two."""
        import threading

        barrier, real = threading.Barrier(2), FakeBuilder()

        def build(name, path):
            barrier.wait(timeout=30)
            time.sleep(0.5)
            return real(name, path)

        monkeypatch.setattr(_kernels, "build", build)
        cc.load_libraries(["fused_sgd", "moe"])
        assert cc.stats()["builds"] == 2
        # the sum of the two would be 1.0 s or more
        assert 0.5 <= cc.stats()["compile_seconds"] < 0.95

    def test_corrupt_local_library_is_discarded(self, fake, cache_dir):
        path = os.path.join(cache_dir, "fused_sgd-%s.so"
                            % cc.library_fingerprint("fused_sgd"))
        os.makedirs(cache_dir, exist_ok=True)
        with open(path, "wb") as fh:
            fh.write(b"\x7fELF torn")
        lib = cc.load_library("fused_sgd")
        assert lib.rung == "built" and fake.built == ["fused_sgd"]
        assert cc.stats()["first_call_rejects"] == 1
        assert lib.fused_sgd_f32() == 0

    def test_the_disable_switch(self, fake, cache_dir, monkeypatch, tmp_path):
        monkeypatch.setenv("TPUJOB_COMPILE_CACHE", "0")
        monkeypatch.setenv("TPUJOB_ARTIFACT_STORE", str(tmp_path / "fleet"))
        lib = cc.load_library("fused_sgd")
        assert lib.rung == "built"
        assert not os.path.exists(cache_dir) or not os.listdir(cache_dir)
        assert not os.path.exists(tmp_path / "fleet")   # nothing published
        assert os.path.dirname(lib.path) != cache_dir
        _restart()
        assert cc.load_library("fused_sgd").rung == "built"
        assert fake.built == ["fused_sgd", "fused_sgd"]   # no reuse

    def test_unwritable_cache_dir_degrades(self, fake, tmp_path,
                                           monkeypatch):
        blocker = tmp_path / "a_file"
        blocker.write_text("not a directory")
        monkeypatch.setenv("TPUJOB_COMPILE_CACHE_DIR",
                           str(blocker / "compile"))
        lib = cc.load_library("paged_decode")
        assert lib.rung == "built" and lib.paged_decode() == 0
        assert cc.startup_block()["cache"] == "built"

    def test_startup_block_reports_the_rung(self, fake):
        assert cc.startup_block()["cache"] == "none"
        cc.load_library("moe")
        assert cc.startup_block()["cache"] == "built"
        _restart()
        cc.load_library("moe")
        blk = cc.startup_block()
        assert blk["cache"] == "local"
        assert blk["libraries"]["moe"]["rung"] == "local"
        cc.load_library("moe")
        assert cc.startup_block()["memo_hits"] == 1
        json.dumps(blk)

    def test_fleet_rung_serves_a_peer_build(self, fake, tmp_path,
                                            monkeypatch):
        monkeypatch.setenv("TPUJOB_ARTIFACT_STORE", str(tmp_path / "fleet"))
        cc.load_library("flash_attention")
        # another pod: its own empty cache dir, the same fleet store
        monkeypatch.setenv("TPUJOB_COMPILE_CACHE_DIR", str(tmp_path / "b"))
        _restart()
        lib = cc.load_library("flash_attention")
        assert lib.rung == "fleet" and fake.built == ["flash_attention"]
        assert cc.startup_block()["cache"] == "fleet"
        assert cc.stats()["fleet_hits"] == 1
        assert lib.flash_attention_fwd() == 0 and lib.verified

    def test_poisoned_fleet_bundle_is_rebuilt(self, fake, tmp_path,
                                              monkeypatch):
        fleet = tmp_path / "fleet"
        monkeypatch.setenv("TPUJOB_ARTIFACT_STORE", str(fleet))
        cc.load_library("fused_sgd")
        fp = cc.library_fingerprint("fused_sgd")
        path = fleet / (fp + ".tpuart")
        raw = bytearray(path.read_bytes())
        raw[-1] ^= 0xFF
        path.write_bytes(bytes(raw))
        monkeypatch.setenv("TPUJOB_COMPILE_CACHE_DIR", str(tmp_path / "b"))
        _restart()
        lib = cc.load_library("fused_sgd")
        assert lib.rung == "built" and fake.built == ["fused_sgd"] * 2
        assert artifacts.get_store().stats()["poisoned_local"] == 1

    def test_metrics_text_is_valid_exposition(self, fake):
        cc.load_library("fused_sgd")
        cc.load_library("fused_sgd")
        text = cc.metrics_text()
        assert parse_exposition(text) == []
        assert 'tpujob_compile_cache_hits_total{layer="memo"} 1' in text
        assert 'tpujob_compile_cache_misses_total{layer="library"} 1' \
            in text


# ---------------------------------------------------------------------------
# the first-use check: rebuild from source, never the plain version
# ---------------------------------------------------------------------------

def _plant(tmp_path, monkeypatch, name, spec):
    """A verified fleet bundle under ``name``'s key whose library is
    ``spec`` (a sound digest over the wrong bytes), and a fresh pod."""
    fleet = tmp_path / "fleet"
    monkeypatch.setenv("TPUJOB_ARTIFACT_STORE", str(fleet))
    ArtifactStore(local_dir=str(fleet)).publish(
        cc.library_fingerprint(name),
        {cc.LIBRARY_MEMBER: json.dumps(spec).encode()})
    _restart()


class TestFirstCallReject:
    def test_missing_symbol_rebuilds_from_source(self, fake, tmp_path,
                                                 monkeypatch):
        _plant(tmp_path, monkeypatch, "fused_sgd",
               {"name": "moe", "symbols": exported("moe")})
        lib = cc.load_library("fused_sgd")
        assert lib.rung == "fleet" and not lib.verified
        fn = lib.fused_sgd_f32
        assert fn() == 0
        assert fake.built == ["fused_sgd"]
        assert lib.rung == "built" and lib.verified
        assert cc.stats()["first_call_rejects"] == 1
        assert artifacts.get_store().stats()["poisoned_local"] == 1
        assert "missing symbol" in cc.libraries()["fused_sgd"]["rejected"]
        assert cc.libraries()["fused_sgd"]["rung"] == "built"

    def test_launch_error_rebuilds_and_calls_the_rebuilt_library(
            self, fake, tmp_path, monkeypatch):
        _plant(tmp_path, monkeypatch, "moe",
               {"name": "moe", "symbols": exported("moe"), "err": 209})
        lib = cc.load_library("moe")
        fn = lib.moe_dispatch
        fn.restype = "int"
        assert fn("x") == 0              # the rebuilt library's answer
        assert fake.built == ["moe"]
        assert lib._cdll.calls == ["moe_dispatch"]
        assert lib.rung == "built"
        # the store was healed: the next pod gets the sound library
        monkeypatch.setenv("TPUJOB_COMPILE_CACHE_DIR", str(tmp_path / "c"))
        _restart()
        healed = cc.load_library("moe")
        assert healed.rung == "fleet" and healed.moe_combine() == 0

    def test_a_failed_rebuild_raises_and_nothing_falls_back(
            self, fake, tmp_path, monkeypatch):
        _plant(tmp_path, monkeypatch, "fused_sgd",
               {"name": "moe", "symbols": exported("moe")})
        lib = cc.load_library("fused_sgd")
        fake.fail = True
        with pytest.raises(_kernels.KernelBuildError):
            lib.fused_sgd_f32

    def test_a_failed_cold_build_raises(self, fake):
        fake.fail = True
        with pytest.raises(_kernels.KernelBuildError):
            _kernels.load("paged_decode")
        assert cc.memo_size() == 0

    def test_a_trusted_library_never_rebuilds(self, fake):
        lib = cc.load_library("fused_sgd")
        with pytest.raises(AttributeError):
            lib.no_such_symbol
        assert fake.built == ["fused_sgd"]


# ---------------------------------------------------------------------------
# lease safety in the fleet rung (the reference's TestFleetRungLeaseSafety)
# ---------------------------------------------------------------------------

class TestFleetRungLeaseSafety:
    def test_lease_released_when_the_refetch_under_it_raises(self, tmp_path):
        class Lease:
            granted = True
            released = False

            def release(self):
                self.released = True

        class Store:
            wait_s = 5.0

            def __init__(self):
                self.lease = Lease()
                self.fetches = 0

            def fetch(self, fp, member=None):
                self.fetches += 1
                if self.fetches == 1:
                    return None, None   # the miss before the lease
                raise RuntimeError("store exploded under the lease")

            def acquire_compile_lease(self, fp):
                return self.lease

        store = Store()
        with pytest.raises(RuntimeError):
            cc._fleet_rung(store, "cd" * 16, str(tmp_path / "x.so"), "t")
        assert store.lease.released

    def test_a_failed_build_releases_the_lease(self, fake, tmp_path,
                                               monkeypatch):
        monkeypatch.setenv("TPUJOB_ARTIFACT_STORE", str(tmp_path / "fleet"))
        fake.fail = True
        with pytest.raises(_kernels.KernelBuildError):
            cc.load_library("moe")
        store = artifacts.get_store()
        fp = cc.library_fingerprint("moe")
        assert store.lease_state(fp) == "free"
        assert store.stats()["lease_granted"] == 1
        fake.fail = False
        assert cc.load_library("moe").rung == "built"

    def test_step_cost_helpers_never_touch_a_raising_store(
            self, cache_dir, monkeypatch):
        class PoisonStore:
            def fetch(self, fp, member=None):
                raise RuntimeError("poisoned bundle rejected")

            def publish(self, fp, members):
                raise RuntimeError("endpoint refused the publish")

        monkeypatch.setattr(artifacts, "get_store", lambda: PoisonStore())
        fp = "ee" * 16
        assert cc.load_step_cost(fp) is None
        cc.save_step_cost(fp, {"flops": 1.0, "bytes": 2.0,
                               "source": "probe"})
        assert cc.load_step_cost(fp) == {"flops": 1.0, "bytes": 2.0,
                                         "source": "probe"}


# ---------------------------------------------------------------------------
# the step-cost sidecar and the runner's rung
# ---------------------------------------------------------------------------

class TestStepCost:
    @pytest.mark.parametrize("torn", [b"{\"flops\": 1", b"[1, 2]"])
    def test_torn_or_malformed_sidecar_is_a_deleted_miss(self, cache_dir,
                                                         torn):
        fp = "ab" * 16
        cc.save_step_cost(fp, {"flops": 3.0, "bytes": 0.0,
                               "source": "flop_counter"})
        path = cc._cost_path(fp)
        with open(path, "wb") as fh:
            fh.write(torn)
        assert cc.load_step_cost(fp) is None
        assert not os.path.exists(path)
        assert cc.stats()["step_cost_misses"] == 1

    def test_unserializable_cost_never_raises(self, cache_dir):
        cc.save_step_cost("cd" * 16, {"flops": object()})
        assert cc.load_step_cost("cd" * 16) is None

    def test_the_cost_never_rides_the_fleet(self, cache_dir, tmp_path,
                                            monkeypatch):
        """The sidecar stays in the cache directory: nothing is published
        (a MOVE's server counts only its state bundle), and another pod's
        directory misses."""
        monkeypatch.setenv("TPUJOB_ARTIFACT_STORE", str(tmp_path / "fleet"))
        cost = {"flops": 123.0, "bytes": 456.0, "source": "flop_counter"}
        cc.save_step_cost("ef" * 16, cost)
        assert cc.load_step_cost("ef" * 16) == cost
        assert artifacts.get_store().stats()["publishes_local"] == 0
        monkeypatch.setenv("TPUJOB_COMPILE_CACHE_DIR", str(tmp_path / "b"))
        _restart()
        assert cc.load_step_cost("ef" * 16) is None


def _job(**kw):
    """A tiny GPT (``TINY_CONFIG``, 8 x 16 tokens, adamw) on the CPU."""
    kw.setdefault("total_steps", 2)
    kw.setdefault("loss_fn",
                  lambda p, b: tgpt.loss_fn(p, b, dtype=torch.float32))
    kw.setdefault("optimizer", topt.adamw(1e-3))
    return TrainJob(
        init_params=lambda gen: tgpt.init(gen, tgpt.TINY_CONFIG),
        make_batch=lambda gen, step: tgpt.synthetic_batch(gen, 8, 16, 1024),
        log_every=1, device="cpu", **kw)


def test_runner_step_cost_rung(cache_dir, monkeypatch):
    """A counted first step saves its cost; the same step again reads it
    back and runs its first step outside the counter (bit-identical
    FLOPs); a torn sidecar is a miss that counts again."""
    counted = run_training(_job())
    assert counted["compile_cache"]["step_cost"] == ["counted"]
    assert counted["hardware"]["cost_source"] == "flop_counter"
    real = trunner.step_cost_of
    calls = []

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(trunner, "step_cost_of", spy)
    hit = run_training(_job())
    assert calls == []
    assert hit["compile_cache"]["step_cost"] == ["cache"]
    assert hit["hardware"]["flops_per_step"] == \
        counted["hardware"]["flops_per_step"]
    assert hit["hardware"]["cost_source"] == "flop_counter"
    sidecars = [f for f in os.listdir(cache_dir) if f.endswith(".cost.json")]
    assert len(sidecars) == 1
    with open(os.path.join(cache_dir, sidecars[0]), "w") as fh:
        fh.write('{"flops": ')
    again = run_training(_job())
    assert calls == [1]
    assert again["compile_cache"]["step_cost"] == ["counted"]
    assert again["hardware"]["flops_per_step"] == \
        counted["hardware"]["flops_per_step"]


def test_runner_step_cost_keys_apart(cache_dir):
    """Another optimizer setting or another number of steps a call is
    another key: both count."""
    run_training(_job())
    other = run_training(_job(optimizer=topt.adamw(2e-3)))
    window = run_training(_job(steps_per_call=2))
    assert other["compile_cache"]["step_cost"] == ["counted"]
    assert window["compile_cache"]["step_cost"] == ["counted"]


def test_runner_step_cost_follows_the_moe_switch(cache_dir, monkeypatch):
    """The same job on the dense MoE path after the kernels' path counts
    its own first step: the switch is in the step's key."""
    monkeypatch.setenv("TPUJOB_MOE_FUSED", "1")
    kernels = run_training(_job())
    monkeypatch.setenv("TPUJOB_MOE_FUSED", "0")
    dense = run_training(_job())
    again = run_training(_job())
    assert kernels["compile_cache"]["step_cost"] == ["counted"]
    assert dense["compile_cache"]["step_cost"] == ["counted"]
    assert again["compile_cache"]["step_cost"] == ["cache"]


def test_no_sidecar_without_a_named_cache_dir(cache_dir, monkeypatch):
    """Without ``TPUJOB_COMPILE_CACHE_DIR`` the step cost persists
    nowhere: the default directory is the checkout's, shared by every run
    there, so each run counts its own first step."""
    monkeypatch.delenv("TPUJOB_COMPILE_CACHE_DIR")
    default = cc.default_cache_dir()

    def sidecars():
        if not os.path.isdir(default):
            return set()
        return {f for f in os.listdir(default) if f.endswith(".cost.json")}

    before = sidecars()
    first = run_training(_job())
    second = run_training(_job())
    assert first["compile_cache"]["step_cost"] == ["counted"]
    assert second["compile_cache"]["step_cost"] == ["counted"]
    assert second["compile_cache"]["step_cost_saves"] == 0
    assert cc._cost_path("ab" * 16) is None
    assert sidecars() == before


def test_runner_compile_badput_is_the_cache_seconds(cache_dir, fake):
    """The run's ``compile`` badput is the nvcc seconds the compile cache
    spent inside it (a build made inside a step)."""
    def loss_fn(p, b):
        _kernels.load("fused_sgd")
        return tgpt.loss_fn(p, b, dtype=torch.float32)

    res = run_training(_job(total_steps=1, loss_fn=loss_fn))
    assert res["compile_cache"]["builds"] == 1
    assert res["compile_cache"]["cache"] == "built"
    assert res["goodput_detail"]["badput_s"].get("compile", 0) > 0


# ---------------------------------------------------------------------------
# held against the JAX package's compile_cache
# ---------------------------------------------------------------------------

def _free_fn(x, y=3):
    return x * y


def _closure(scale, table):
    def inner(x):
        return x * scale + len(table)
    return inner


DESCRIBED = [
    0, 7, -3, 2.5, float("inf"), True, None, "dp", b"raw",
    {"b": 1, "a": [1, 2.0, "x"]}, [1, (2, 3), {"k": None}], (),
    math, np, _free_fn, functools.partial(_free_fn, y=4),
    _closure(0.5, {"a": 1}), _closure(0.25, [1, 2]), len,
    {"opt": (functools.partial(_free_fn, 2), 0.9), "nested": {"x": [True]}},
]


@pytest.mark.parametrize("i", range(len(DESCRIBED)))
def test_describe_matches_the_reference(i):
    obj = DESCRIBED[i]
    assert cc._describe(obj) == ref_cc._describe(obj)


def test_describe_code_matches_the_reference():
    for fn in (_free_fn, _closure, _mlp_loss, _sgd_step(0.1)):
        assert cc._describe_code(fn.__code__) == \
            ref_cc._describe_code(fn.__code__)


def test_big_arrays_describe_as_the_reference_does():
    """Shape and dtype, past the reference's value-hash size (the port
    never reads values)."""
    big = np.zeros((128, 64), np.float32)
    assert cc._describe(big) == ref_cc._describe(big)
    t = torch.zeros(128, 64)
    assert cc._describe(t) == "torch.float32(128, 64)"
    assert cc._describe(torch.ones(2, 2)) == cc._describe(torch.zeros(2, 2))


def _ref_setup(seed=0, rows=8):
    p, b = _mlp_setup(seed, rows)
    conv = lambda t: {k: jnp.asarray(v.numpy()) for k, v in t.items()}  # noqa
    return conv(p), conv(b)


def _ref_loss(params, batch):
    h = jnp.tanh(batch["x"] @ params["w1"])
    return ((h @ params["w2"] - batch["y"]) ** 2).mean(), {}


def _ref_step(lr):
    def step(params, batch):
        return {k: v - lr * v for k, v in params.items()}
    return step


@pytest.mark.parametrize("case", ["values", "shape", "closure", "config",
                                  "same"])
def test_fingerprint_answers_as_the_reference(cache_dir, case, tmp_path,
                                              monkeypatch):
    """The same operations on the same inputs give the same verdict
    (equal or not) in both packages."""
    monkeypatch.setenv("TPUJOB_COMPILE_CACHE_DIR", str(tmp_path / "ref"))
    ref_cc.reset_stats_for_tests()
    fns = {"port": (_mlp_loss, _sgd_step, _mlp_setup),
           "ref": (_ref_loss, _ref_step, _ref_setup)}
    verdicts = {}
    for pkg, (loss, step, setup) in fns.items():
        fp = cc.step_fingerprint if pkg == "port" else ref_cc.step_fingerprint
        p, b = setup()
        a = fp(loss, (p, b), config=1)
        if case == "values":
            p2, b2 = setup(seed=9)
            other = fp(loss, (p2, b2), config=1)
        elif case == "shape":
            p2, b2 = setup(rows=16)
            other = fp(loss, (p2, b2), config=1)
        elif case == "closure":
            a = fp(step(0.1), (p, b), config=1)
            other = fp(step(0.2), (p, b), config=1)
        elif case == "config":
            other = fp(loss, (p, b), config=4)
        else:
            other = fp(loss, (p, b), config=1)
        verdicts[pkg] = a == other
    assert verdicts["port"] == verdicts["ref"]
    ref_cc.reset_stats_for_tests()


def test_sidecar_json_matches_the_reference(cache_dir, tmp_path,
                                            monkeypatch):
    """The sidecar's bytes are the reference's, and each package reads
    the other's."""
    cost = {"flops": 3110281936896.0, "bytes": 0.0, "source": "flop_counter"}
    fp = "ab" * 16
    cc.save_step_cost(fp, cost)
    monkeypatch.setenv("TPUJOB_COMPILE_CACHE_DIR", str(tmp_path / "ref"))
    ref_cc.reset_stats_for_tests()
    ref_cc.save_step_cost(fp, cost)
    ref_path = ref_cc._cost_path(fp)
    monkeypatch.setenv("TPUJOB_COMPILE_CACHE_DIR", cache_dir)
    with open(cc._cost_path(fp), "rb") as fh:
        port_bytes = fh.read()
    with open(ref_path, "rb") as fh:
        assert fh.read() == port_bytes
    assert cc.load_step_cost(fp) == cost
    monkeypatch.setenv("TPUJOB_COMPILE_CACHE_DIR", str(tmp_path / "ref"))
    assert ref_cc.load_step_cost(fp) == cost
    ref_cc.reset_stats_for_tests()


def test_startup_block_keys_match_the_reference(cache_dir, tmp_path,
                                                monkeypatch):
    """The keys a reader of ``result["compile_cache"]`` takes from the
    reference's block are in the port's, with the same types."""
    monkeypatch.setenv("TPUJOB_COMPILE_CACHE_DIR", str(tmp_path / "ref"))
    ref_cc.reset_stats_for_tests()
    ref = ref_cc.startup_block()
    port = cc.startup_block()
    shared = {"cache", "dir", "memo_hits", "fleet_hits", "compile_seconds",
              "artifacts"}
    assert shared <= set(ref) and shared <= set(port)
    for key in shared:
        assert type(port[key]) is type(ref[key]), key
    assert port["artifacts"] == ref["artifacts"] == {"configured": False}
    assert port["cache"] in cc.RUNGS + ("none",)
    ref_cc.reset_stats_for_tests()
