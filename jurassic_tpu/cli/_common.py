"""Shared helpers for the CLI tools (reference-compatible argv handling)."""
from __future__ import annotations

import os
import sys
from typing import Sequence

from ..config import Ctl, CtlScanner, read_ctl
from ..platform import enable_compile_cache

# Reference parity on the host backend: the C implementation computes in
# double precision on the CPU (jurassic.h real_t), so CPU-pinned CLI
# runs (JAX_PLATFORMS=cpu) enable x64 by default (opt out with
# JURASSIC_FP32=1).  GPU runs keep the float32 compute path.
if (os.environ.get("JAX_PLATFORMS", "").lower() == "cpu"
        and not os.environ.get("JURASSIC_FP32")):
    import jax
    jax.config.update("jax_enable_x64", True)

# Sanitizer analogue (SURVEY section 5: jax.debug NaN checking in place
# of cuda-memcheck/asserts): opt-in NaN trapping for kernel debugging.
if os.environ.get("JURASSIC_DEBUG_NANS"):
    import jax
    jax.config.update("jax_debug_nans", True)


def die(msg: str) -> None:
    print(f"\nError: {msg}\n")
    sys.exit(1)


def cli_main(fn):
    """Wrap a CLI entry point: user-input errors exit(1) with a clean
    message instead of a traceback."""
    def wrapper(argv=None):
        from ..config import CtlError
        enable_compile_cache()
        try:
            return fn(argv)
        except SystemExit:
            raise
        except (CtlError, ValueError, OSError) as e:
            die(str(e))
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def load_ctl(argv: Sequence[str], min_args: int, usage: str) -> tuple[Ctl, CtlScanner]:
    if len(argv) < min_args:
        die(f"Give parameters: {usage}")
    ctl = read_ctl(argv)
    scanner = CtlScanner(argv)
    scanner.verbose = False
    return ctl, scanner
