"""Fused EGA kernel (ops/rt_fused.py) vs the exact/jnp paths.

The kernel compiles for the GPU through Pallas' Triton route; on the CPU
test backend it runs in Pallas interpret mode, which the tests request
explicitly (``ForwardModel(..., interpret=True)``).  The kernel computes
in float32 (like the reference GPU payloads, jurassic.h:387), so
tolerances sit above the float32 epsilon but far below the physics
accuracy of the EGA method itself.
"""
from pathlib import Path

import numpy as np
import pytest

from jurassic_tpu.forward import ForwardModel, RtOut
from jurassic_tpu.models.synthetic import (fast_to_ega_tables, limb_workload,
                                           synthetic_atm, synthetic_ctl,
                                           synthetic_fast_tables)
from jurassic_tpu.ops.rt_fused import default_blocks, rt_fused

from test_forward_golden import run_case

GOLD = Path(__file__).parent / "goldens"


def _kernel_vs_jnp(ctl, ft, atm, obs, blocks=None):
    """(rad, tau) of the f64 jnp fast path and of the kernel on the same
    traced rays; ``blocks`` runs the bare kernel with that tile."""
    ctl.kernel = "jax"
    m_jax = ForwardModel(ctl, fast_tables=ft)
    los = m_jax.trace(atm, obs)
    out_jax = m_jax.integrate(los)
    ctl.kernel = "pallas"
    m_pal = ForwardModel(ctl, fast_tables=ft, interpret=True)
    assert m_pal.kernel_mode == "pallas"
    if blocks is None:
        out_pal = m_pal.integrate(los)
    else:
        out_pal = RtOut(*rt_fused(
            m_pal.dev_tbl, m_pal.kernel_axes, m_pal.cc_rows, m_pal.sr,
            m_pal.st, los, flags=m_pal.flags, ig_co2=m_pal.ig_co2,
            ig_h2o=m_pal.ig_h2o, interpret=True, blocks=blocks))
    return ((np.asarray(out_jax.rad), np.asarray(out_jax.tau)),
            (np.asarray(out_pal.rad), np.asarray(out_pal.tau)))


def _assert_close(ref, got, tol=1e-5):
    (rad0, tau0), (rad1, tau1) = ref, got
    assert rad1.shape == rad0.shape and tau1.shape == tau0.shape
    scale = np.abs(rad0).max()
    assert np.abs(rad1 - rad0).max() <= tol * scale
    assert np.abs(tau1 - tau0).max() <= tol


@pytest.mark.parametrize("case", ["limb", "nadir", "ega"])
def test_pallas_matches_reference_golden(case):
    """kernel=pallas on the three golden cases against the C oracle."""
    ctl, obs, ref = run_case(case, "pallas")
    nd = ctl.nd
    rad_ref = ref[:, 10:10 + nd]
    tau_ref = ref[:, 10 + nd:10 + 2 * nd]
    scale = np.abs(rad_ref).max()
    assert np.abs(obs.rad - rad_ref).max() <= 2e-3 * scale
    assert np.abs(obs.tau - tau_ref).max() <= 2e-3


def test_pallas_matches_fast_jnp_synthetic():
    """Pallas vs the jnp fast path on a multi-gas synthetic limb
    workload with all four continua active: the float32 kernel must
    track the float64 jnp path to ~1e-5 relative."""
    ctl = synthetic_ctl(ng=4, nd=9)
    ctl.nlos = 48
    ctl.rayds = 50.0
    ctl.raydz = 5.0
    ctl.ctm_n2 = ctl.ctm_o2 = 1   # force all continua on
    ft = synthetic_fast_tables(ctl, n_p=8, n_t=5, n_k=48)
    ref, got = _kernel_vs_jnp(ctl, ft, synthetic_atm(ctl),
                              limb_workload(ctl, 6))
    _assert_close(ref, got)


FLAG_SETS = {"none": (0, 0, 0, 0), "co2": (1, 0, 0, 0),
             "h2o": (0, 1, 0, 0), "n2": (0, 0, 1, 0), "o2": (0, 0, 0, 1),
             "all": (1, 1, 1, 1)}


@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_pallas_continuum_flags_match_jnp(flags):
    """Every static continuum specialisation of the kernel (the
    reference's 16 compiled variants, jr_multiversion4gases.h): none,
    each continuum alone, and all four, on channels that reach the N2
    (2120-2605 /cm) and O2 (1360-1805 /cm) bands."""
    ctl = synthetic_ctl(ng=3, nd=10, nu0=700.0, nu1=2500.0)
    ctl.nlos = 40
    ctl.rayds, ctl.raydz = 60.0, 6.0
    (ctl.ctm_co2, ctl.ctm_h2o, ctl.ctm_n2, ctl.ctm_o2) = FLAG_SETS[flags]
    ft = synthetic_fast_tables(ctl, n_p=6, n_t=4, n_k=40)
    ref, got = _kernel_vs_jnp(ctl, ft, synthetic_atm(ctl),
                              limb_workload(ctl, 3))
    _assert_close(ref, got)


@pytest.mark.parametrize("nr", [1, 7])
@pytest.mark.parametrize("nd", [1, 100, 130])
def test_pallas_ragged_block_shapes(nd, nr):
    """Ray counts and channel counts that are not block multiples: the
    ray axis pads by repeating the last ray, the channel tail is masked
    at the store (nd = 130 spans two 128-lane blocks).  One ray runs the
    GPU's one-ray tile."""
    ctl = synthetic_ctl(ng=2, nd=nd)
    ctl.nlos = 24
    ctl.rayds, ctl.raydz = 80.0, 8.0
    ft = synthetic_fast_tables(ctl, n_p=5, n_t=4, n_k=24)
    blocks = (1,) + default_blocks(nd)[1:] if nr == 1 else None
    ref, got = _kernel_vs_jnp(ctl, ft, synthetic_atm(ctl, dz=5.0),
                              limb_workload(ctl, nr), blocks=blocks)
    assert got[0].shape == (nr, nd)
    _assert_close(ref, got)


def test_default_blocks():
    """One ray per program and one channel per thread, up to 128
    channels per program; block widths are powers of two."""
    assert default_blocks(100) == (1, 128, 4)
    assert default_blocks(1) == (1, 16, 1)
    assert default_blocks(1024) == (1, 128, 4)
    assert default_blocks(40) == (1, 64, 2)
    assert default_blocks(100, interpret=True) == (8, 128, 4)


def test_pallas_rejects_ragged_tables():
    """KERNEL = pallas must fail loudly (not silently fall back) when
    table axes are ragged across channels."""
    ctl = synthetic_ctl(ng=2, nd=4)
    ft = synthetic_fast_tables(ctl, n_p=6, n_t=4, n_k=32)
    # make channel 1's pressure axis differ from channel 0's
    p = np.array(ft.p)
    p[0, :, 1] *= 1.5
    ft = ft._replace(p=p)
    ctl.kernel = "pallas"
    with pytest.raises(ValueError, match="channel-uniform"):
        ForwardModel(ctl, fast_tables=ft, interpret=True)
    # auto mode takes the jnp fast kernel
    ctl.kernel = "auto"
    assert ForwardModel(ctl, fast_tables=ft).kernel_mode == "jax"


def test_pallas_declared_but_unreferenced_windows():
    """ctl.nw larger than max(window)+1 (declared windows that no
    channel references): the kernel statically reads one continuum row
    per declared window, so pack_continua must size the one-hot block
    by nw.  The pallas and jnp paths must agree."""
    ctl = synthetic_ctl(ng=2, nd=4)
    ctl.nlos = 32
    ctl.rayds, ctl.raydz = 60.0, 6.0
    ctl.nw = 2
    ctl.window = [0, 0, 0, 0]          # window 1 declared, unreferenced
    ft = synthetic_fast_tables(ctl, n_p=6, n_t=4, n_k=32)
    atm = synthetic_atm(ctl)
    atm.k = np.full((ctl.nw, atm.npts), 1e-4)   # nonzero extinction
    ref, got = _kernel_vs_jnp(ctl, ft, atm, limb_workload(ctl, 4))
    _assert_close(ref, got)


def test_pallas_exact_cross_validation():
    """Pallas vs the exact reference-faithful oracle on materialized
    synthetic tables (fast-vs-exact tolerance, FAST_INVERSE_OF_U)."""
    ctl = synthetic_ctl(ng=2, nd=5)
    ctl.nlos = 40
    ctl.rayds = 60.0
    ctl.raydz = 6.0
    ft = synthetic_fast_tables(ctl, n_p=8, n_t=5, n_k=64)
    atm = synthetic_atm(ctl)
    obs = limb_workload(ctl, 4)

    ctl.kernel = "exact"
    m_ex = ForwardModel(ctl, tables=fast_to_ega_tables(ft))
    los = m_ex.trace(atm, obs)
    out_ex = m_ex.integrate(los)

    ctl.kernel = "pallas"
    m_pal = ForwardModel(ctl, fast_tables=ft, interpret=True)
    out_pal = m_pal.integrate(los)

    rad0 = np.asarray(out_ex.rad)
    scale = np.abs(rad0).max()
    assert np.abs(np.asarray(out_pal.rad) - rad0).max() <= 2e-3 * scale
