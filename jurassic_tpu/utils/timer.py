"""Nested wall-clock timer stack + jax.profiler integration.

Re-expression of the reference timer subsystem (``timer``,
jurassic.c:1224-1246; ``TIMER(name, mode)`` macro, jurassic.h:92): a
static 10-deep stack of start times, mode 1 = start, 3 = stop + print,
-3 = silent stop returning the elapsed seconds (used by the benchmark
harness for statistics, formod.c:96-104).

The analogue of the reference's gprof / ``-Xptxas -v`` hooks
(Makefile:21,53,72) is :func:`profile_trace`: an opt-in
``jax.profiler.trace`` context producing a Perfetto/TensorBoard trace
with XLA kernel-level time attribution.
"""
from __future__ import annotations

import contextlib
import inspect
import time

MAX_TIMERS = 10

_stack: list[tuple[float, int]] = []


def timer(name: str, mode: int, _caller=None) -> float:
    """TIMER(name, mode): 1 start, 3 stop+print, -3 silent stop.

    Mirrors the semantics (and the 10-deep limit) of jurassic.c:1224-1246.
    Returns the elapsed wall-clock seconds on stop modes, else 0.
    """
    frame = _caller or inspect.stack()[1]
    line = frame.lineno
    fname = frame.filename.rsplit("/", 1)[-1]
    func = frame.function
    dt_w = 0.0
    if mode == 1:
        if len(_stack) >= MAX_TIMERS:
            raise RuntimeError(f"Too many timers! max. is {MAX_TIMERS}")
        _stack.append((time.time(), line))
    else:
        if not _stack:
            raise RuntimeError("Coding error!")
        w0, l0 = _stack[-1]
        dt_w = time.time() - w0
        if mode != -3:
            print(f"Timer '{name}' ({fname}, {func}, l{l0}-{line}): "
                  f"{dt_w:.3f} sec")
    if abs(mode) == 3:
        _stack.pop()
    return dt_w


@contextlib.contextmanager
def timed(name: str, silent: bool = False):
    """Context-manager form: ``with timed("raytrace"):`` prints the
    elapsed time on exit (or stays silent and stores it in ``.dt``)."""
    frame = inspect.stack()[2]
    timer(name, 1, frame)
    box = type("T", (), {"dt": 0.0})()
    try:
        yield box
    finally:
        box.dt = timer(name, -3 if silent else 3, frame)


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """Opt-in jax.profiler trace around a region; no-op when logdir is
    falsy.  View with TensorBoard or Perfetto (the kernel-level cost
    attribution the reference got from gprof / ptxas reports)."""
    if not logdir:
        yield
        return
    import jax
    with jax.profiler.trace(str(logdir)):
        yield
