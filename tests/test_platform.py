"""The platform decision, the kernel choice, the compile cache, RAYPACK
sizing and chip_smoke.py's refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from jurassic_tpu import platform
from jurassic_tpu.config import CtlError, read_ctl
from jurassic_tpu.forward import ForwardModel, resolve_kernel
from jurassic_tpu.models.synthetic import synthetic_ctl, synthetic_fast_tables

REPO = Path(__file__).resolve().parent.parent
GOLD = REPO / "tests" / "goldens"


@pytest.fixture(scope="module")
def small():
    ctl = synthetic_ctl(ng=2, nd=4)
    return ctl, synthetic_fast_tables(ctl, n_p=6, n_t=4, n_k=32)


@pytest.mark.parametrize("backend,mode", [("gpu", "pallas"), ("cpu", "jax")])
def test_auto_kernel_follows_the_backend(monkeypatch, small, backend, mode):
    """KERNEL = auto: the fused kernel on a GPU backend, the jnp scan on
    the CPU; interpret mode is never chosen for the caller."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    ctl, ft = small
    ctl.kernel, ctl.usegpu = "auto", -1
    model = ForwardModel(ctl, fast_tables=ft)
    assert model.platform == backend
    assert model.kernel_mode == mode and not model.interpret


def test_pallas_off_the_gpu_needs_interpret(small):
    ctl, ft = small
    ctl.kernel = "pallas"
    with pytest.raises(ValueError, match="interpret=True"):
        ForwardModel(ctl, fast_tables=ft)
    assert ForwardModel(ctl, fast_tables=ft, interpret=True).interpret
    ctl.kernel = "auto"


def test_usegpu_required_refused_without_gpu(small):
    ctl, ft = small
    ctl.usegpu = 1
    with pytest.raises(ValueError, match="USEGPU = 1"):
        ForwardModel(ctl, fast_tables=ft)
    ctl.usegpu = -1


@pytest.mark.parametrize("key", ["KERNEL turbo", "EARLY_EXIT 1",
                                 "USETPU 1"])
def test_removed_modes_are_rejected(key):
    """The Chebyshev (turbo) tables, the opacity early exit and the old
    USETPU key are gone: each fails with a message naming it."""
    name, value = key.split()
    argv = ["formod", str(GOLD / "ega" / "ega.ctl"), "o", "a", "r",
            name, value]
    if name == "KERNEL":
        ctl = read_ctl(argv, verbose=False)
        with pytest.raises(ValueError, match="turbo"):
            resolve_kernel(ctl.kernel, "gpu", False)
    else:
        with pytest.raises(CtlError, match=name):
            read_ctl(argv, verbose=False)


@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_placement(monkeypatch, tmp_path, env):
    """JAX_COMPILATION_CACHE_DIR is honoured and left to JAX; without it
    the cache goes to the fixed <checkout>/.jax_cache."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert platform.enable_compile_cache() == REPO / ".jax_cache"
        assert calls == [("jax_compilation_cache_dir",
                          str(REPO / ".jax_cache"))]
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env))
        assert platform.enable_compile_cache() == tmp_path / env
        assert calls == []


class _FakeGpu:
    platform = "gpu"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats", [None, {"bytes_limit": 2 * 10**9,
                                          "bytes_in_use": 0}])
def test_raypack_auto_sizes_from_memory_stats(monkeypatch, small, stats):
    """RAYPACK auto on an accelerator sizes packages from memory_stats and
    fails loudly when the device reports none (no assumed capacity)."""
    ctl, ft = small
    model = ForwardModel(ctl, fast_tables=ft)
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k:
                        [_FakeGpu(stats)])
    nr = 10**6
    if stats is None:
        with pytest.raises(RuntimeError, match="memory_stats"):
            model._resolve_raypack(nr)
        return
    fit = model._resolve_raypack(nr)
    assert fit == int(0.9 * 2e9) // 2 // model.per_ray_device_bytes()
    assert 0 < model.package_size(nr) <= fit


def test_per_ray_bytes_follow_the_path(small):
    """The RAYPACK byte model describes the path that runs: the kernel's
    streams and the jnp scan's step copies differ, and both grow with
    the LOS budget."""
    ctl, ft = small
    sizes = {}
    for kernel in ("pallas", "jax"):
        for nlos in (100, 400):
            ctl.kernel, ctl.nlos = kernel, nlos
            m = ForwardModel(ctl, fast_tables=ft, interpret=True)
            sizes[kernel, nlos] = m.per_ray_device_bytes()
    ctl.kernel, ctl.nlos = "auto", 400
    assert sizes["pallas", 400] != sizes["jax", 400]
    for kernel in ("pallas", "jax"):
        assert sizes[kernel, 400] > sizes[kernel, 100] > 0


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """chip_smoke.py exits non-zero and prints no result when JAX finds no
    GPU, and when it stands alone without the package."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / script.name)
        script, cwd = tmp_path / script.name, tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
