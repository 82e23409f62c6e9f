"""Flagship-scale golden tests (BASELINE configs[2]/[3] class).

* flagship -- 100 channels across three bands (790-880, 1400-1700,
  2150-2500 /cm) x 5 gases with all four continua (CO2, H2O, N2, O2)
  active and HYDZ=10 hydrostatics: the refspec-class many-channel
  coverage the reference exercises in example/refspec/run.sh:7-14.
  Only the ASCII outputs are committed; the synthetic tables regenerate
  deterministically from tools/make_synthetic_tables.py (the C oracle
  consumed the identical files when tools/make_goldens.sh produced
  rad.tab).
* fov -- the limb example with an FOV shape file: exercises the
  field-of-view convolution (formod_fov, jurassic.c:214-258) end to end
  against the reference binary's output.
"""
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from jurassic_tpu.config import read_ctl
from jurassic_tpu.forward import ForwardModel
from jurassic_tpu.io_tab import read_atm, read_obs

GOLD = Path(__file__).parent / "goldens"
TOOLS = Path(__file__).parent.parent / "tools"


@pytest.fixture(scope="module")
def flagship_dir(tmp_path_factory):
    """Golden ASCII files + regenerated synthetic tables in one dir."""
    d = tmp_path_factory.mktemp("flagship")
    src = GOLD / "flagship"
    for f in src.iterdir():
        shutil.copy(f, d / f.name)
    ctl = read_ctl(["x", str(d / "flagship.ctl"), "o", "a", "r"],
                   verbose=False)
    subprocess.run(
        [sys.executable, str(TOOLS / "make_synthetic_tables.py"), str(d),
         "--tblbase", "synth", "--gases", *ctl.emitter[:ctl.ng],
         "--channels", *[f"{x:.4f}" for x in ctl.nu]],
        check=True, stdout=subprocess.DEVNULL)
    return d


def run_dir(d: Path, kernel: str):
    ctl_file = next(d.glob("*.ctl"))
    ctl = read_ctl(["formod", str(ctl_file), "obs.tab", "atm.tab", "rad"],
                   verbose=False)
    ctl.kernel = kernel
    ctl.tblbase = str(d / Path(ctl.tblbase).name)
    if ctl.fov != "-":
        ctl.fov = str(d / Path(ctl.fov).name)
    obs = read_obs(d / "obs.tab", ctl)
    atm = read_atm(d / "atm.tab", ctl)
    fm = ForwardModel(ctl, directory=str(d), interpret=kernel == "pallas")
    fm.formod(atm, obs)
    ref = np.loadtxt(d / "rad.tab")
    return ctl, obs, ref


def test_flagship_exact_matches_reference(flagship_dir):
    """50 rays x 100 channels x 5 gases, all continua, hydrostatics."""
    ctl, obs, ref = run_dir(flagship_dir, "exact")
    assert ctl.nd == 100 and ctl.ng == 5
    assert ctl.ctm_co2 and ctl.ctm_h2o and ctl.ctm_n2 and ctl.ctm_o2
    nd = ctl.nd
    rad_ref = ref[:, 10:10 + nd]
    tau_ref = ref[:, 10 + nd:10 + 2 * nd]
    np.testing.assert_allclose(obs.tpz, ref[:, 7], rtol=0, atol=2e-4)
    # per-band scale: the three bands span orders of magnitude in
    # radiance, so normalize per channel-block (40/30/30 channels)
    for sl in (slice(0, 40), slice(40, 70), slice(70, 100)):
        scale = np.abs(rad_ref[:, sl]).max()
        assert np.abs(obs.rad[:, sl] - rad_ref[:, sl]).max() <= 1e-5 * scale
    assert np.abs(obs.tau - tau_ref).max() <= 5e-6


def test_flagship_fast_close_to_exact(flagship_dir):
    ctl, obs, ref = run_dir(flagship_dir, "fast")
    nd = ctl.nd
    rad_ref = ref[:, 10:10 + nd]
    for sl in (slice(0, 40), slice(40, 70), slice(70, 100)):
        scale = np.abs(rad_ref[:, sl]).max()
        assert np.abs(obs.rad[:, sl] - rad_ref[:, sl]).max() <= 2e-3 * scale


def test_flagship_pallas_matches_reference(flagship_dir):
    """The fused kernel on the flagship golden (100 channels x 5 gases,
    all four continua) against the C oracle, at the kernel's bar."""
    ctl, obs, ref = run_dir(flagship_dir, "pallas")
    nd = ctl.nd
    rad_ref = ref[:, 10:10 + nd]
    tau_ref = ref[:, 10 + nd:10 + 2 * nd]
    for sl in (slice(0, 40), slice(40, 70), slice(70, 100)):
        scale = np.abs(rad_ref[:, sl]).max()
        assert np.abs(obs.rad[:, sl] - rad_ref[:, sl]).max() <= 2e-3 * scale
    assert np.abs(obs.tau - tau_ref).max() <= 2e-3


def test_fov_convolution_matches_reference():
    """FOV convolution golden (formod_fov, jurassic.c:214-258).

    jurassic-gpu's own formod driver never calls formod_fov (dead code
    upstream), so rad_fov.tab comes from tools/fov_oracle.c — a harness
    linked against the reference jurassic.o that applies formod_fov to
    the reference formod output.  Our formod applies the convolution
    inline, so it must reproduce that post-convolution golden."""
    d = GOLD / "fov"
    ctl, obs, _ = run_dir(d, "exact")
    assert ctl.fov != "-"
    nd = ctl.nd
    ref = np.loadtxt(d / "rad_fov.tab")
    rad_ref = ref[:, 10:10 + nd]
    tau_ref = ref[:, 10 + nd:10 + 2 * nd]
    scale = np.abs(rad_ref).max()
    assert np.abs(obs.rad - rad_ref).max() <= 5e-6 * scale
    assert np.abs(obs.tau - tau_ref).max() <= 2e-6
    # and the convolution actually changed the profile vs the plain run
    plain = np.loadtxt(d / "rad.tab")
    assert np.abs(plain[:, 10:10 + nd] - rad_ref).max() > 1e-3 * scale
