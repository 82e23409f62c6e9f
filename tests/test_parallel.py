"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The analogue of the reference's CPU<->GPU cross-validation (the same
physics executed by a differently parallelised driver must agree,
formod.c:106-166): the SPMD rays x chan sharded run must match the
single-device run to float tolerance, including when the ray count does
not divide the mesh (padding path).
"""
from pathlib import Path

import jax
import numpy as np
import pytest

from jurassic_tpu.config import read_ctl
from jurassic_tpu.forward import ForwardModel
from jurassic_tpu.io_tab import read_atm, read_obs
from jurassic_tpu.parallel import ShardedForwardModel, make_mesh

GOLD = Path(__file__).parent / "goldens"


def _load(case="ega"):
    d = GOLD / case
    ctl_file = next(d.glob("*.ctl"))
    ctl = read_ctl(["formod", str(ctl_file), "o", "a", "r"], verbose=False)
    ctl.tblbase = str(d / Path(ctl.tblbase).name)
    return ctl, d


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 1)])
def test_sharded_matches_single_device(mesh_shape):
    ctl, d = _load("ega")
    obs = read_obs(d / "obs.tab", ctl)
    atm = read_atm(d / "atm.tab", ctl)
    fm = ForwardModel(ctl, directory=str(d))
    fm.formod(atm, obs)

    nray, nchan = mesh_shape
    if nray * nchan > len(jax.devices()):
        pytest.skip("not enough devices")
    mesh = make_mesh(nray, nchan)
    obs2 = read_obs(d / "obs.tab", ctl)
    atm2 = read_atm(d / "atm.tab", ctl)
    sfm = ShardedForwardModel(ctl, mesh, directory=str(d))
    sfm.formod(atm2, obs2)

    np.testing.assert_allclose(obs2.rad, obs.rad, rtol=1e-12, atol=0)
    np.testing.assert_allclose(obs2.tau, obs.tau, rtol=1e-12, atol=0)
    np.testing.assert_allclose(obs2.tpz, obs.tpz, rtol=1e-12, atol=0)


def test_sharded_ray_padding():
    """Ray count not divisible by the mesh: padded rays must not leak."""
    ctl, d = _load("ega")
    obs = read_obs(d / "obs.tab", ctl)
    atm = read_atm(d / "atm.tab", ctl)
    # trim to a count coprime with 8
    import dataclasses
    from jurassic_tpu.io_tab import Obs
    n = obs.nr - 3
    obs = Obs(**{f.name: np.asarray(getattr(obs, f.name))[:n]
                 for f in dataclasses.fields(Obs)})
    fm = ForwardModel(ctl, directory=str(d))
    rad_single = fm.formod(atm, obs.copy()).rad

    mesh = make_mesh(8, 1)
    sfm = ShardedForwardModel(ctl, mesh, directory=str(d))
    out = sfm.formod(read_atm(d / "atm.tab", ctl), obs.copy())
    assert out.rad.shape == (n, ctl.nd)
    np.testing.assert_allclose(out.rad, rad_single, rtol=1e-12, atol=0)


def test_synthetic_workload_smoke():
    """Benchmark workload pieces compose and produce finite radiances."""
    from jurassic_tpu.models.synthetic import (fast_to_ega_tables,
                                               limb_workload, synthetic_atm,
                                               synthetic_ctl,
                                               synthetic_fast_tables)
    ctl = synthetic_ctl(ng=2, nd=8)
    ctl.nlos = 48
    ctl.rayds, ctl.raydz = 50.0, 5.0
    ft = synthetic_fast_tables(ctl, n_p=8, n_t=6, n_k=64)
    atm = synthetic_atm(ctl, dz=5.0)
    obs = limb_workload(ctl, 12)
    fm = ForwardModel(ctl, fast_tables=ft)
    fm.formod(atm, obs)
    assert np.isfinite(obs.rad).all()
    assert (obs.rad > 0).any()
    # exact-kernel route through the materialised u payload
    ctl2 = synthetic_ctl(ng=2, nd=8)
    ctl2.nlos, ctl2.rayds, ctl2.raydz = 48, 50.0, 5.0
    ctl2.kernel = "exact"
    fm2 = ForwardModel(ctl2, tables=fast_to_ega_tables(ft))
    obs2 = limb_workload(ctl2, 12)
    fm2.formod(synthetic_atm(ctl2, dz=5.0), obs2)
    scale = np.abs(obs.rad).max()
    assert np.abs(obs2.rad - obs.rad).max() < 2e-3 * scale


@pytest.mark.parametrize("mesh_shape,kernel",
                         [((4, 2), "pallas"), ((8, 1), "pallas")])
def test_sharded_pallas_matches_single_device(mesh_shape, kernel):
    """The fused kernel is the multi-device path: shard_map-dispatched
    per-shard kernels over the ("rays","chan") mesh must reproduce the
    single-device kernel run (each shard sees the same per-channel table
    slices and the same per-ray segments).  Runs in interpret mode on the
    virtual CPU mesh; the same code path compiles for GPUs."""
    ctl, d = _load("ega")
    ctl.kernel = kernel
    obs = read_obs(d / "obs.tab", ctl)
    atm = read_atm(d / "atm.tab", ctl)
    fm = ForwardModel(ctl, directory=str(d), interpret=True)
    assert fm.kernel_mode == "pallas"
    fm.formod(atm, obs)

    nray, nchan = mesh_shape
    if nray * nchan > len(jax.devices()):
        pytest.skip("not enough devices")
    mesh = make_mesh(nray, nchan)
    obs2 = read_obs(d / "obs.tab", ctl)
    atm2 = read_atm(d / "atm.tab", ctl)
    sfm = ShardedForwardModel(ctl, mesh, directory=str(d), interpret=True)
    assert sfm.kernel_mode == "pallas"
    sfm.formod(atm2, obs2)

    np.testing.assert_allclose(obs2.rad, obs.rad, rtol=1e-6, atol=0)
    np.testing.assert_allclose(obs2.tau, obs.tau, rtol=1e-6, atol=0)


def test_sharded_pallas_raypack():
    """RAYPACK package pipelining must work under the mesh with the
    fused kernel (the reference's multi-GPU package loop,
    GPUdrivers.cu:331-358)."""
    ctl, d = _load("ega")
    ctl.kernel = "pallas"
    obs = read_obs(d / "obs.tab", ctl)
    atm = read_atm(d / "atm.tab", ctl)
    fm = ForwardModel(ctl, directory=str(d), interpret=True)
    rad_single = fm.formod(atm, obs.copy()).rad

    mesh = make_mesh(4, 2)
    ctl.raypack = 3   # odd size: rounds up to the mesh multiple (4)
    sfm = ShardedForwardModel(ctl, mesh, directory=str(d), interpret=True)
    out = sfm.formod(read_atm(d / "atm.tab", ctl), obs.copy())
    np.testing.assert_allclose(out.rad, rad_single, rtol=1e-6, atol=0)


def test_init_distributed_plumbing(monkeypatch):
    """init_distributed: no-op without coordinator env/args; passes the
    coordinator config through to jax.distributed.initialize (the
    multi-host analogue of the reference's MPI-rank device selection,
    jurassic.h:336-338)."""
    import jax
    from jurassic_tpu.parallel.mesh import init_distributed
    calls = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.update(kw))
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    init_distributed()
    assert not calls                       # single-process: no-op
    init_distributed("host0:1234", num_processes=2, process_id=1)
    assert calls == {"coordinator_address": "host0:1234",
                     "num_processes": 2, "process_id": 1}
    calls.clear()
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "host9:99")
    init_distributed()
    assert calls["coordinator_address"] is None  # env-driven path
