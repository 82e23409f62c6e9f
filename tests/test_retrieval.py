"""Retrieval interface tests (C19, SURVEY.md 2.2).

Pack/unpack round trips mirror atm2x/x2atm and obs2y/y2obs
(jurassic.c:1473-1541); the finite-difference Jacobian (kernel,
jurassic.c:812-857) is cross-validated against the autodiff Jacobian
(jax.jacfwd through the jitted pipeline) on a synthetic workload.
"""
import numpy as np
import pytest

from jurassic_tpu.forward import ForwardModel
from jurassic_tpu.io_tab import read_matrix, write_matrix
from jurassic_tpu.models.synthetic import (limb_workload, synthetic_atm,
                                           synthetic_ctl,
                                           synthetic_fast_tables)
from jurassic_tpu.retrieval import (IDXP, IDXT, atm2x, idx2name, kernel,
                                    kernel_autodiff, obs2y, x2atm, y2obs)


@pytest.fixture(scope="module")
def setup():
    ctl = synthetic_ctl(ng=2, nd=4)
    ctl.nlos = 96
    ctl.rayds = 50.0
    ctl.raydz = 5.0
    # retrieve T and gas-1 vmr in a mid-altitude band, pressure nowhere
    ctl.rett_zmin, ctl.rett_zmax = 10.0, 30.0
    ctl.retq_zmin = [-999.0, 20.0]
    ctl.retq_zmax = [-999.0, 40.0]
    atm = synthetic_atm(ctl, dz=5.0)
    obs = limb_workload(ctl, 4)
    model = ForwardModel(ctl, fast_tables=synthetic_fast_tables(
        ctl, n_p=12, n_t=8, n_k=96))
    return ctl, atm, obs, model


def test_atm2x_roundtrip(setup):
    ctl, atm, _, _ = setup
    x, iqa, ipa = atm2x(ctl, atm)
    # T band: z in [10, 30] at dz=5 -> 5 levels; q[1]: [20, 40] -> 5 levels
    assert x.size == 10
    assert (iqa[:5] == IDXT).all() and (iqa[5:] == 3).all()
    assert idx2name(ctl, IDXT) == "TEMPERATURE"
    assert idx2name(ctl, 3) == ctl.emitter[1]
    atm1 = atm.copy()
    x2atm(ctl, x + 1.0, atm1)
    x1, _, _ = atm2x(ctl, atm1)
    np.testing.assert_allclose(x1, x + 1.0)
    # untouched quantities stay put
    np.testing.assert_array_equal(atm1.p, atm.p)
    np.testing.assert_array_equal(atm1.q[0], atm.q[0])


def test_obs2y_roundtrip_and_mask(setup):
    ctl, _, obs, _ = setup
    o = obs.copy()
    o.rad[:] = np.arange(o.rad.size).reshape(o.rad.shape)
    o.rad[1, 2] = np.nan                      # masked cell drops out
    y, ida, ira = obs2y(ctl, o)
    assert y.size == o.rad.size - 1
    assert not np.any((ira == 1) & (ida == 2))
    y2obs(ctl, y * 2.0, o)
    assert o.rad[0, 0] == 0.0 and np.isnan(o.rad[1, 2])
    assert o.rad[2, 1] == 2.0 * (2 * ctl.nd + 1)


def test_fd_vs_autodiff_jacobian(setup):
    ctl, atm, obs, model = setup
    K_fd = kernel(ctl, atm.copy(), obs.copy(), model)
    K_ad = kernel_autodiff(ctl, atm.copy(), obs.copy(), model)
    assert K_fd.shape == K_ad.shape == (obs.nr * ctl.nd, 10)
    scale = np.abs(K_ad).max()
    assert scale > 0
    # FD truncation: agree to ~1% of the dominant sensitivity
    np.testing.assert_allclose(K_fd, K_ad, atol=2e-2 * scale, rtol=0.05)


def test_autodiff_vs_fd_through_pallas():
    """The autodiff/kernel-path seam: kernel_autodiff differentiates the
    jnp pipeline even for a model whose FORWARD runs the fused kernel,
    so an FD Jacobian computed through the kernel forward mixes paths.
    The two must still agree at the FD-truncation tolerance -- the seam
    is a documented approximation, not a correctness hole."""
    ctl = synthetic_ctl(ng=2, nd=4)
    ctl.nlos = 48
    ctl.rayds, ctl.raydz = 50.0, 5.0
    # tiny state: 3 temperature levels (every interpret-mode kernel
    # forward costs about a second on the CPU test backend)
    ctl.rett_zmin, ctl.rett_zmax = 10.0, 20.0
    atm = synthetic_atm(ctl, dz=5.0)
    obs = limb_workload(ctl, 4)
    ft = synthetic_fast_tables(ctl, n_p=8, n_t=5, n_k=40)
    ctl.kernel = "pallas"
    model = ForwardModel(ctl, fast_tables=ft, interpret=True)
    assert model.kernel_mode == "pallas"
    K_fd = kernel(ctl, atm.copy(), obs.copy(), model)   # kernel forward
    K_ad = kernel_autodiff(ctl, atm.copy(), obs.copy(), model)  # jnp
    assert K_fd.shape == K_ad.shape == (obs.nr * ctl.nd, 3)
    scale = np.abs(K_ad).max()
    assert scale > 0
    # the float32 kernel forward deviates from jnp by ~1e-6 relative;
    # across the 1 K FD step that is far inside the 1% FD truncation
    # budget
    np.testing.assert_allclose(K_fd, K_ad, atol=2e-2 * scale, rtol=0.05)


def test_fd_vs_autodiff_hydrostatic_large_state():
    """HYDZ >= 0 (differentiable hydrostatic rebuild in the traced graph)
    with a 100+-element state vector: the vectorized scatter and the
    in-graph hydrostatics must reproduce the FD kernel, which re-runs
    hydrostatic_atm per perturbation (jurassic.c:812-857 +
    jr_common.h:728-761)."""
    ctl = synthetic_ctl(ng=2, nd=3)
    ctl.nlos = 96
    ctl.rayds = 50.0
    ctl.raydz = 5.0
    ctl.hydz = 20.0
    # T + both gas vmr over the full column -> 3 * 46 = 138 elements
    ctl.rett_zmin, ctl.rett_zmax = 0.0, 70.0
    ctl.retq_zmin = [0.0, 0.0]
    ctl.retq_zmax = [70.0, 70.0]
    atm = synthetic_atm(ctl)
    obs = limb_workload(ctl, 3)
    model = ForwardModel(ctl, fast_tables=synthetic_fast_tables(
        ctl, n_p=12, n_t=8, n_k=96))
    K_fd = kernel(ctl, atm.copy(), obs.copy(), model)
    K_ad = kernel_autodiff(ctl, atm.copy(), obs.copy(), model)
    assert K_fd.shape == K_ad.shape and K_fd.shape[1] >= 100
    scale = np.abs(K_ad).max()
    assert scale > 0
    np.testing.assert_allclose(K_fd, K_ad, atol=2e-2 * scale, rtol=0.05)


def test_fd_vs_autodiff_multi_profile():
    """Multi-profile atmosphere (satellite-track batch: two scans with
    distinct time stamps, each with its own (lon, lat) profile): the
    autodiff Jacobian must scatter the state into the right profile and
    gather per-ray profiles by scan time exactly like the FD kernel's
    full forward models do (locate_atm, jr_common.h:128-154)."""
    from jurassic_tpu.io_tab import Atm

    ctl = synthetic_ctl(ng=2, nd=3)
    ctl.nlos = 96
    ctl.rayds = 50.0
    ctl.raydz = 5.0
    ctl.hydz = 20.0
    ctl.rett_zmin, ctl.rett_zmax = 10.0, 40.0
    ctl.retq_zmin = [-999.0, 10.0]
    ctl.retq_zmax = [-999.0, 40.0]
    a0 = synthetic_atm(ctl, dz=5.0)
    a1 = synthetic_atm(ctl, dz=5.0)
    a1.t = a1.t + 6.0                    # the second scan sees warmer air
    a1.q[1] = a1.q[1] * 1.4
    atm = Atm(
        time=np.concatenate([a0.time, a1.time + 3600.0]),
        z=np.concatenate([a0.z, a1.z]),
        lon=np.concatenate([a0.lon, np.full(a1.npts, 10.0)]),
        lat=np.concatenate([a0.lat, np.full(a1.npts, 5.0)]),
        p=np.concatenate([a0.p, a1.p]),
        t=np.concatenate([a0.t, a1.t]),
        q=np.concatenate([a0.q, a1.q], axis=1),
        k=np.concatenate([a0.k, a1.k], axis=1))
    obs = limb_workload(ctl, 6)
    obs.time[3:] = 3600.0                # rays 3.. view the second scan
    model = ForwardModel(ctl, fast_tables=synthetic_fast_tables(
        ctl, n_p=12, n_t=8, n_k=96))
    K_fd = kernel(ctl, atm.copy(), obs.copy(), model)
    K_ad = kernel_autodiff(ctl, atm.copy(), obs.copy(), model)
    # both profiles contribute state elements
    x, iqa, ipa = atm2x(ctl, atm)
    assert (ipa < a0.npts).any() and (ipa >= a0.npts).any()
    assert K_fd.shape == K_ad.shape == (obs.nr * ctl.nd, x.size)
    scale = np.abs(K_ad).max()
    assert scale > 0
    np.testing.assert_allclose(K_fd, K_ad, atol=2e-2 * scale, rtol=0.05)
    # cross-profile sensitivities are exactly zero: ray 0 (scan 1) must
    # not react to scan-2 state and vice versa
    nd = ctl.nd
    ray0_rows = slice(0, nd)
    scan2_cols = ipa >= a0.npts
    assert np.abs(K_ad[ray0_rows, :][:, scan2_cols]).max() == 0.0
    ray5_rows = slice(5 * nd, 6 * nd)
    assert np.abs(K_ad[ray5_rows, :][:, ~scan2_cols]).max() == 0.0


def test_write_read_matrix_roundtrip(tmp_path, setup):
    ctl, atm, obs, model = setup
    ctl.write_matrix = 1
    obs1 = obs.copy()
    model.formod(atm.copy(), obs1)
    K = kernel_autodiff(ctl, atm.copy(), obs.copy(), model)
    path = tmp_path / "matrix.tab"
    write_matrix(path, ctl, K, atm, obs1, "y", "x", "r")
    K2 = read_matrix(path, K.shape)
    nz = K != 0
    np.testing.assert_allclose(K2[nz], K[nz], rtol=1e-4)


def test_fd_vs_autodiff_float32():
    """The Jacobian in float32, the GPU's working precision: the column
    density's temperature derivative must stay finite ((KB*T)**2
    underflows float32) and agree with the FD Jacobian."""
    import jax.numpy as jnp
    ctl = synthetic_ctl(ng=2, nd=4)
    ctl.nlos = 96
    ctl.rayds, ctl.raydz = 50.0, 5.0
    ctl.rett_zmin, ctl.rett_zmax = 10.0, 30.0
    atm = synthetic_atm(ctl, dz=5.0)
    obs = limb_workload(ctl, 4)
    model = ForwardModel(ctl, dtype=jnp.float32,
                         fast_tables=synthetic_fast_tables(
                             ctl, n_p=12, n_t=8, n_k=96))
    K_fd = kernel(ctl, atm.copy(), obs.copy(), model)
    K_ad = kernel_autodiff(ctl, atm.copy(), obs.copy(), model)
    assert np.isfinite(K_ad).all()
    scale = np.abs(K_ad).max()
    assert scale > 0
    np.testing.assert_allclose(K_fd, K_ad, atol=2e-2 * scale, rtol=0.05)
