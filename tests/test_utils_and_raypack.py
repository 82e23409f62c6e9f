"""Timer-stack semantics (jurassic.c:1224-1246) and the RAYPACK
pipelined package loop (the stream/package-overlap analogue of
GPUdrivers.cu:176-183)."""
import numpy as np
import pytest

from jurassic_tpu.forward import ForwardModel
from jurassic_tpu.models.synthetic import (limb_workload, synthetic_atm,
                                           synthetic_ctl,
                                           synthetic_fast_tables)
from jurassic_tpu.utils import timed, timer


def test_timer_stack_nesting(capsys):
    timer("outer", 1)
    timer("inner", 1)
    dt_in = timer("inner", 3)
    dt_out = timer("outer", -3)        # silent stop
    assert 0 <= dt_in <= dt_out
    out = capsys.readouterr().out
    assert "Timer 'inner'" in out and "outer" not in out


def test_timer_errors():
    with pytest.raises(RuntimeError, match="Coding error"):
        timer("nothing-started", 3)
    for i in range(10):
        timer(f"t{i}", 1)
    with pytest.raises(RuntimeError, match="Too many timers"):
        timer("overflow", 1)
    for _ in range(11):
        try:
            timer("x", -3)
        except RuntimeError:
            break


def test_timed_context(capsys):
    with timed("block") as t:
        pass
    assert t.dt >= 0
    assert "Timer 'block'" in capsys.readouterr().out
    with timed("silent", silent=True) as t:
        pass
    assert "silent" not in capsys.readouterr().out


def test_formod_selector_guard():
    """FORMOD != 2 must fail loudly: the reference ships only EGA and
    hard-asserts on the CGA selector (jr_common.h:701-707); RFM is
    declared but unimplemented there too."""
    ctl = synthetic_ctl(ng=2, nd=4)
    ft = synthetic_fast_tables(ctl, n_p=6, n_t=4, n_k=32)
    for sel in (1, 3):
        ctl.formod = sel
        with pytest.raises(ValueError, match="FORMOD"):
            ForwardModel(ctl, fast_tables=ft)
    ctl.formod = 2
    ForwardModel(ctl, fast_tables=ft)


def test_usetpu_dispatch(monkeypatch):
    """USEGPU -1/0/1 execution-path dispatch (the reference's useGPU
    "if possible / never / required", CPUdrivers.c:179-193): 0 pins the
    jnp pipeline on the host CPU backend, 1 demands a GPU backend, -1
    takes the GPU when there is one."""
    import jax
    ctl = synthetic_ctl(ng=2, nd=4)
    ft = synthetic_fast_tables(ctl, n_p=6, n_t=4, n_k=32)
    atm = synthetic_atm(ctl)
    obs = limb_workload(ctl, 3)

    # pretend a GPU backend is active (construction only: nothing here
    # compiles the kernel for the CPU devices)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")

    ctl.usegpu = -1
    assert ForwardModel(ctl, fast_tables=ft).kernel_mode == "pallas"
    ctl.usegpu = 1
    assert ForwardModel(ctl, fast_tables=ft).kernel_mode == "pallas"
    ctl.usegpu = 0
    m0 = ForwardModel(ctl, fast_tables=ft)
    assert m0.kernel_mode == "jax"           # never the accelerator path
    assert m0.exec_device is not None        # pinned to host CPU
    assert m0.exec_device.platform == "cpu"
    m0.formod(atm, obs.copy())               # runs end to end when pinned
    # an explicit kernel on the pinned CPU runs only when the caller asks
    # for interpret mode
    ctl.kernel = "pallas"
    with pytest.raises(ValueError, match="interpret"):
        ForwardModel(ctl, fast_tables=ft)
    mp = ForwardModel(ctl, fast_tables=ft, interpret=True)
    assert mp.kernel_mode == "pallas" and mp.interpret
    ctl.kernel = "auto"

    # a CPU-only backend must refuse USEGPU = 1
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    ctl.usegpu = 1
    with pytest.raises(ValueError, match="USEGPU = 1"):
        ForwardModel(ctl, fast_tables=ft)
    ctl.usegpu = 0
    assert ForwardModel(ctl, fast_tables=ft).exec_device is None
    ctl.usegpu = -1


def test_raypack_bitwise_identical():
    """Packaged execution pads the last package by repeating the final
    ray, so every package shares one compiled shape and the results are
    bitwise identical to the monolithic batch."""
    ctl = synthetic_ctl(ng=3, nd=8)
    ctl.nlos = 120
    ctl.rayds = 20.0
    ctl.raydz = 2.0
    ft = synthetic_fast_tables(ctl, n_p=8, n_t=5, n_k=48)
    atm = synthetic_atm(ctl)
    obs = limb_workload(ctl, 37)       # deliberately not pack-aligned
    m = ForwardModel(ctl, fast_tables=ft)
    o1 = obs.copy()
    m.formod(atm, o1)
    ctl.raypack = 16
    o2 = obs.copy()
    m.formod(atm, o2)
    np.testing.assert_array_equal(o1.rad, o2.rad)
    np.testing.assert_array_equal(o1.tau, o2.tau)
    np.testing.assert_array_equal(o1.tpz, o2.tpz)
    ctl.raypack = 0


def test_hash_cli_matches_reference():
    """djb2 values captured from the reference's own hash function
    (jr_simple_string_hash.h:6-15 compiled and run on these strings);
    the CLI prints the 0x%lx format of hash.c:33."""
    from jurassic_tpu.cli.strhash import djb2_64, main
    golden = {
        "CO2": 0xB87DA49,
        "H2O": 0xB87EBEE,
        "NU": 0x5974A8,
        "CLIMATOLOGY": 0xBFC69EE6A254E6A9,
        "jurassic-gpu": 0xD4DB58C432A53942,
    }
    for s, h in golden.items():
        assert djb2_64(s) == h
    assert main(["hash", "CO2"]) == 0
