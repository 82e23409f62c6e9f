"""Card-only tests: the fused kernel compiled for the GPU.

Marked ``gpu``: each takes the ``gpu`` fixture, which skips without a GPU
(the CPU suite cannot compile the kernel; it runs in interpret mode
there).  ``python chip_smoke.py`` runs these functions on the card,
passing the device.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jurassic_tpu.forward import ForwardModel
from jurassic_tpu.models.synthetic import (limb_workload, synthetic_atm,
                                           synthetic_ctl,
                                           synthetic_fast_tables)

pytestmark = pytest.mark.gpu


def _workload():
    """130 channels (a 128-lane block plus a masked tail) reaching every
    continuum band, 3 gases, 17 rays."""
    ctl = synthetic_ctl(ng=3, nd=130, nu0=700.0, nu1=2500.0)
    ctl.nlos = 120
    ctl.rayds, ctl.raydz = 30.0, 2.0
    ft = synthetic_fast_tables(ctl, n_p=12, n_t=8, n_k=64)
    return ctl, ft, synthetic_atm(ctl), limb_workload(ctl, 17)


def test_compiled_kernel_matches_xla_scan(gpu):
    """The compiled kernel against XLA's scan on the same traced rays, at
    the kernel's 1e-5 bar."""
    ctl, ft, atm, obs = _workload()
    with jax.default_device(gpu):
        ctl.kernel = "jax"
        xla = ForwardModel(ctl, fast_tables=ft, dtype=jnp.float32)
        los = xla.trace(atm, obs)
        ref = xla.integrate(los)
        ctl.kernel = "pallas"
        ker = ForwardModel(ctl, fast_tables=ft, dtype=jnp.float32)
        assert ker.kernel_mode == "pallas" and not ker.interpret
        out = ker.integrate(los)
    rad0 = np.asarray(ref.rad)
    scale = np.abs(rad0).max()
    err_rad = np.abs(np.asarray(out.rad) - rad0).max() / scale
    err_tau = np.abs(np.asarray(out.tau) - np.asarray(ref.tau)).max()
    assert err_rad <= 1e-5, err_rad
    assert err_tau <= 1e-5, err_tau


def test_compiled_kernel_matches_interpreter(gpu):
    """The kernel compiled by Triton against the same kernel in Pallas
    interpret mode on the host CPU, on identical inputs: only the math
    libraries and the instruction order differ (the kernel's 1e-5 bar)."""
    ctl, ft, atm, obs = _workload()
    ctl.kernel = "pallas"
    cpu = jax.local_devices(backend="cpu")[0]
    with jax.default_device(cpu):
        host = ForwardModel(ctl, fast_tables=ft, dtype=jnp.float32,
                            interpret=True)
        los = host.trace(atm, obs)
        want = host.integrate(los)
    with jax.default_device(gpu):
        card = ForwardModel(ctl, fast_tables=ft, dtype=jnp.float32)
        got = card.integrate(jax.device_put(los, gpu))
    rad0 = np.asarray(want.rad)
    scale = np.abs(rad0).max()
    err_rad = np.abs(np.asarray(got.rad) - rad0).max() / scale
    err_tau = np.abs(np.asarray(got.tau) - np.asarray(want.tau)).max()
    # the kernel's 1e-5 bar: libdevice's exp2/log2/pow/tanh and XLA:CPU's
    # differ in the last bits, compounded over the LOS
    assert err_rad <= 1e-5, err_rad
    assert err_tau <= 1e-5, err_tau


def test_usegpu_required_takes_the_kernel(gpu):
    """USEGPU = 1 is met on the card, and KERNEL = auto resolves to the
    compiled kernel there."""
    ctl, ft, atm, obs = _workload()
    ctl = dataclasses.replace(ctl, usegpu=1, kernel="auto")
    with jax.default_device(gpu):
        model = ForwardModel(ctl, fast_tables=ft, dtype=jnp.float32)
        assert model.platform == "gpu" and model.exec_device is None
        assert model.kernel_mode == "pallas" and not model.interpret
        out = model.formod(atm.copy(), obs.copy())
    assert np.isfinite(out.rad).all() and out.rad.shape == (obs.nr, ctl.nd)
