"""Process set-up (compile cache, device description), the peak-rate table
and the native library's build from its sources."""

import ctypes
import os
import shutil
import threading

import jax
import pytest

from raytracingtest_tpu import native
from raytracingtest_tpu.utils import runtime
from raytracingtest_tpu.utils.profiling import (
    peak_hbm_bytes_per_s, traversal_roofline)

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_is_left_alone(monkeypatch, tmp_path,
                                         restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_into_the_checkout(monkeypatch,
                                                  restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.setup_compile_cache()
    assert path == os.path.join(runtime.REPO_ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # a fixed path: the same on every call
    assert runtime.setup_compile_cache() == path


def test_device_info_on_host_devices():
    assert runtime.device_info() == {"platform": "cpu", "kind": "cpu",
                                     "count": 8}


def test_peak_table_known_kind():
    assert peak_hbm_bytes_per_s(H100) == 3.35e12
    r = traversal_roofline(1 << 20, 10, 60.0, H100)
    assert r["bytes"] == (1 << 20) * 60.0 * 40
    assert r["ideal_s"] == pytest.approx(r["bytes"] / 3.35e12)
    assert r["rays_per_s_ceiling"] > 1e8


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 PCIe"])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no peak rates"):
        traversal_roofline(1 << 20, 10, 60.0, kind)


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """The native sources in a scratch directory, with the module pointed
    at it."""
    src = os.path.join(runtime.REPO_ROOT, "csrc")
    dst = tmp_path / "csrc"
    dst.mkdir()
    for name in os.listdir(src):
        if name.endswith((".cpp", "Makefile")):
            shutil.copy2(os.path.join(src, name), dst / name)
    monkeypatch.setattr(native, "_CSRC", str(dst))
    monkeypatch.setattr(native, "_SO", str(dst / "libsvo.so"))
    return dst


def test_native_rebuilds_when_a_source_is_newer(csrc_copy):
    assert native.stale()                    # no library yet
    assert native.build()
    assert not native.stale()
    so = csrc_copy / "libsvo.so"
    # age the library below a source's time stamp
    older = os.path.getmtime(csrc_copy / "noise.cpp") - 10
    os.utime(so, (older, older))
    assert native.stale()
    assert native.build()
    assert not native.stale()
    assert os.path.getmtime(so) > older


def test_native_build_replaces_atomically(csrc_copy):
    """Concurrent builds (as in parallel test workers) each compile to their
    own file and rename it over the library: all succeed, nothing
    half-written or temporary is left, and the result loads."""
    ok = []
    threads = [threading.Thread(target=lambda: ok.append(native.build()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ok == [True] * 4
    assert sorted(os.listdir(csrc_copy)) == [
        "Makefile", "esvo.cpp", "libsvo.so", "morton.cpp", "noise.cpp"]
    lib = ctypes.CDLL(str(csrc_copy / "libsvo.so"))
    assert hasattr(lib, "rtt_trace")


def test_fenced_median_ms_calls_once_more_to_compile():
    import jax.numpy as jnp
    from raytracingtest_tpu.utils.profiling import fenced_median_ms

    calls = []

    def fn():
        calls.append(1)
        return jnp.ones(4) * len(calls)

    ms = fenced_median_ms(fn, 5)
    assert len(calls) == 6 and ms >= 0.0
