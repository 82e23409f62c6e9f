"""Reference-capacity gas count golden (VERDICT r4 item 2).

The reference sizes NG = 30 (jurassic.h:138-145) and its refspec
example drives all 30 emitters (example/refspec/template.ctl:10-39,
run.sh:16-29); every round-4 kernel test ran G <= 5.  This case runs
the EXACT refspec emitter list -- 28 gases with synthetic analytic
tables plus the table-less N2/O2 emitters (transparent, the reference's
missing-table behaviour, jr_common.h:240-246) -- through every kernel
path against the locally compiled C oracle's rad.tab
(tools/ref_build; tables regenerate deterministically from
tools/make_synthetic_tables.py, which produced the oracle's inputs).
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
def gas30_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("gas30")
    src = GOLD / "gas30"
    for f in src.iterdir():
        shutil.copy(f, d / f.name)
    ctl = read_ctl(["x", str(d / "gas30.ctl"), "o", "a", "r"],
                   verbose=False)
    gases = [g for g in ctl.emitter[:ctl.ng] if g not in ("N2", "O2")]
    subprocess.run(
        [sys.executable, str(TOOLS / "make_synthetic_tables.py"), str(d),
         "--tblbase", "synth", "--gases", *gases,
         "--channels", *[f"{x:.4f}" for x in ctl.nu]],
        check=True, stdout=subprocess.DEVNULL)
    return d


def run_dir(d: Path, kernel: str):
    ctl_file = d / "gas30.ctl"
    ctl = read_ctl(["formod", str(ctl_file), "obs.tab", "atm.tab", "rad"],
                   verbose=False)
    ctl.kernel = kernel
    ctl.tblbase = str(d / "synth")
    obs = read_obs(d / "obs.tab", ctl)
    atm = read_atm(d / "atm.tab", ctl)
    fm = ForwardModel(ctl, directory=str(d), interpret=kernel == "pallas")
    fm.formod(atm, obs)
    ref = np.loadtxt(d / "rad.tab")
    return ctl, fm, obs, ref


def test_gas30_exact_matches_reference(gas30_dir):
    ctl, _, obs, ref = run_dir(gas30_dir, "exact")
    assert ctl.ng == 30
    nd = ctl.nd
    rad_ref = ref[:, 10:10 + nd]
    tau_ref = ref[:, 10 + nd:10 + 2 * nd]
    # per-channel scale: the 2400/cm channel is orders dimmer
    scale = np.abs(rad_ref).max(axis=0)
    assert (np.abs(obs.rad - rad_ref).max(axis=0) <= 1e-5 * scale).all()
    assert np.abs(obs.tau - tau_ref).max() <= 5e-6


def test_gas30_pallas_matches_reference(gas30_dir):
    """The fused kernel at the reference's gas capacity (NG = 30, with the
    table-less N2/O2 emitters transparent) against the C oracle, at the
    kernel's golden bar."""
    ctl, fm, obs, ref = run_dir(gas30_dir, "pallas")
    assert fm.kernel_mode == "pallas" and ctl.ng == 30
    nd = ctl.nd
    rad_ref = ref[:, 10:10 + nd]
    tau_ref = ref[:, 10 + nd:10 + 2 * nd]
    scale = np.abs(rad_ref).max(axis=0)
    assert (np.abs(obs.rad - rad_ref).max(axis=0) <= 2e-3 * scale).all()
    assert np.abs(obs.tau - tau_ref).max() <= 2e-3
