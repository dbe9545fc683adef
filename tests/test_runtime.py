"""Process set-up (movi_tpu/runtime.py) and the device memory budget
(engine/select.py): compile-cache placement, platform choice, and where
the engine budget comes from."""

import os
import subprocess
import sys

import pytest

import jax

from movi_tpu import runtime
from movi_tpu.engine import select

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_compile_cache_env_set_sets_nothing(monkeypatch, tmp_path,
                                            config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert config_updates == []


def test_compile_cache_default_is_checkout_root(monkeypatch,
                                                config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".xla_cache")
    assert runtime.enable_compile_cache() == want
    assert config_updates == [("jax_compilation_cache_dir", want)]


class _FakeDevice:
    def __init__(self, platform, stats=None, kind="fake"):
        self.platform = platform
        self.device_kind = kind
        self._stats = stats

    def memory_stats(self):
        return self._stats


def _use_device(monkeypatch, dev):
    monkeypatch.delenv("MOVI_TPU_HBM_BYTES", raising=False)
    monkeypatch.setattr(jax, "devices", lambda *a: [dev])


def test_budget_reads_gpu_bytes_limit(monkeypatch):
    _use_device(monkeypatch, _FakeDevice("gpu", {"bytes_limit": 63 << 30}))
    assert select.device_memory_budget() == 63 << 30


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_budget_gpu_without_limit_raises(monkeypatch, stats):
    _use_device(monkeypatch, _FakeDevice("gpu", stats))
    with pytest.raises(RuntimeError):
        select.device_memory_budget()


def test_budget_cpu_is_host_memory(monkeypatch):
    _use_device(monkeypatch, _FakeDevice("cpu"))
    want = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert select.device_memory_budget() == want


def test_budget_unknown_device_raises(monkeypatch):
    _use_device(monkeypatch, _FakeDevice("unknown", {"bytes_limit": 1 << 34}))
    with pytest.raises(RuntimeError):
        select.device_memory_budget()


def test_budget_env_override(monkeypatch):
    _use_device(monkeypatch, _FakeDevice("unknown"))
    monkeypatch.setenv("MOVI_TPU_HBM_BYTES", "12345")
    assert select.device_memory_budget() == 12345


def test_cli_gpu_platform_without_gpu_fails():
    """--platform gpu on a machine without one exits non-zero before
    touching the index; it never carries on on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "movi_tpu.cli", "query", "--index",
         "/nonexistent", "--read", "/nonexistent", "--pml",
         "--platform", "gpu"],
        cwd=REPO, env=env, capture_output=True, text=True)
    assert r.returncode != 0
    assert "platform 'gpu'" in r.stderr


def test_require_gpu_on_cpu_exits():
    with pytest.raises(SystemExit):
        runtime.require_gpu()


def test_device_facts_on_cpu():
    facts = runtime.device_facts()
    assert facts["platform"] == "cpu"
    assert facts["count"] == len(jax.devices())


def test_bench_without_gpu_exits_nonzero():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                       env=env, capture_output=True, text=True)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "needs a GPU" in r.stderr
