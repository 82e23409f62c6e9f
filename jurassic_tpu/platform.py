"""Where formod runs, and where compiled programs are cached.

:func:`select_platform` is the one platform decision of the package: the
reference's ``useGPU`` -1/0/1 ("if possible / never / required",
CPUdrivers.c:179-193) read from the ctl key ``USEGPU``.
:func:`enable_compile_cache` points JAX's persistent compilation cache at
a fixed directory of the checkout unless ``JAX_COMPILATION_CACHE_DIR``
already names one.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import NamedTuple

import jax

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE_DIR = CHECKOUT / ".jax_cache"


class Platform(NamedTuple):
    name: str            # "gpu": the fused kernel can run compiled
    exec_device: object  # device to pin the pipeline to, or None


def select_platform(usegpu: int) -> Platform:
    """USEGPU = 1 requires a GPU backend, 0 pins the host CPU (and so the
    jnp pipeline), -1 takes the GPU when JAX's default backend is one."""
    backend = jax.default_backend()
    if usegpu >= 1 and backend != "gpu":
        raise ValueError(
            f"USEGPU = 1 (required) but the JAX backend is '{backend}'; "
            "run where JAX finds a GPU (the reference aborts the same way "
            "when useGPU = 1 finds no CUDA device, CPUdrivers.c:185-188)")
    if usegpu == 0:
        pin = (jax.local_devices(backend="cpu")[0]
               if backend != "cpu" else None)
        return Platform("cpu", pin)
    return Platform("gpu" if backend == "gpu" else "cpu", None)


def enable_compile_cache() -> Path:
    """Turn on the persistent compile cache and return its directory.
    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so with it set nothing
    is changed here; otherwise the cache goes to the fixed
    ``<checkout>/.jax_cache`` (a path that moved would never hit)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return Path(env)
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return CACHE_DIR
