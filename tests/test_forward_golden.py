"""End-to-end golden-file tests against the reference CPU binary.

The fixtures in tests/goldens/ were produced by the locally compiled
reference implementation (tools/build_reference.sh + tools/make_goldens.sh),
mirroring the reference's own test strategy (example/limb/run.sh:71-72:
``diff rad.tab rad.org``).  Three cases:

* limb  -- the reference limb example (stub tables: raytracing, CO2/H2O
           continua, source function);
* nadir -- surface emission + brightness-temperature output (WRITE_BBT);
* ega   -- synthetic analytic emissivity tables exercising the EGA hot
           path (tools/make_synthetic_tables.py).

Golden columns (write_obs, jurassic.c:1426-1470): 0 time, 1-3 observer,
4-6 view point, 7-9 tangent point, 10.. rad, 10+nd.. tau.  The reference
prints %g (6 significant digits), which sets the comparison floor.
"""
from pathlib import Path

import numpy as np
import pytest

from jurassic_tpu.config import read_ctl
from jurassic_tpu.forward import ForwardModel
from jurassic_tpu.io_tab import read_atm, read_obs

GOLD = Path(__file__).parent / "goldens"


def run_case(case: str, kernel: str):
    d = GOLD / case
    ctl_file = next(d.glob("*.ctl"))
    ctl = read_ctl(["formod", str(ctl_file), "obs.tab", "atm.tab", "rad"],
                   verbose=False)
    ctl.kernel = kernel
    ctl.tblbase = str(d / Path(ctl.tblbase).name)
    obs = read_obs(d / "obs.tab", ctl)
    atm = read_atm(d / "atm.tab", ctl)
    fm = ForwardModel(ctl, directory=str(d), interpret=kernel == "pallas")
    fm.formod(atm, obs)
    ref = np.loadtxt(d / "rad.tab")
    return ctl, obs, ref


@pytest.mark.parametrize("case", ["limb", "nadir", "ega"])
def test_formod_exact_matches_reference(case):
    ctl, obs, ref = run_case(case, "exact")
    nd = ctl.nd
    rad_ref = ref[:, 10:10 + nd]
    tau_ref = ref[:, 10 + nd:10 + 2 * nd]
    # tangent points: pure geometry (traceray + tangent_point)
    np.testing.assert_allclose(obs.tpz, ref[:, 7], rtol=0, atol=2e-4)
    np.testing.assert_allclose(obs.tplat, ref[:, 9], rtol=0, atol=2e-4)
    # %g print precision floor: 6 significant digits
    scale = np.abs(rad_ref).max()
    assert np.abs(obs.rad - rad_ref).max() <= 5e-6 * scale
    assert np.abs(obs.tau - tau_ref).max() <= 2e-6


def test_formod_fast_close_to_exact():
    """The fast (log-uniform resampled) kernel must stay within the
    documented FAST_INVERSE_OF_U-style tolerance of the exact path."""
    _, obs_fast, ref = run_case("ega", "fast")
    nd = 2
    rad_ref = ref[:, 10:10 + nd]
    tau_ref = ref[:, 10 + nd:10 + 2 * nd]
    scale = np.abs(rad_ref).max()
    assert np.abs(obs_fast.rad - rad_ref).max() <= 2e-3 * scale
    assert np.abs(obs_fast.tau - tau_ref).max() <= 2e-3


def test_formod_checkmode_skips_compute(capsys, tmp_path):
    """CHECKMODE validates files and dims without computing or writing
    (jurassic.c:892-896, 1046-1050, 401-413, 1427-1430)."""
    d = GOLD / "limb"
    ctl = read_ctl(["formod", str(d / "limb.ctl"), "o", "a", "r",
                    "CHECKMODE", "1"], verbose=False)
    # reads validate existence but skip the parse
    obs = read_obs(d / "obs.tab", ctl)
    atm = read_atm(d / "atm.tab", ctl)
    assert obs.nr == 0 and atm.npts == 0
    # a missing file still fails fast
    import pytest
    with pytest.raises(OSError):
        read_obs(d / "no_such_obs.tab", ctl)
    from jurassic_tpu.forward import formod
    from jurassic_tpu.io_tab import write_obs
    from jurassic_tpu.tables import tables_checkmode
    formod(ctl, atm, obs)
    tables_checkmode(ctl, str(d))
    out = tmp_path / "rad.tab"
    write_obs(out, ctl, obs)
    assert not out.exists()                  # write skipped
    text = capsys.readouterr().out
    assert "but skip" in text
    assert "no actual computation" in text
    assert "try to initialize tables" in text


def test_observation_mask():
    """NaN radiances in the input mark cells to skip; they must come back
    NaN (save_mask/apply_mask, jr_common.h:193-210)."""
    d = GOLD / "ega"
    ctl = read_ctl(["formod", str(d / "ega.ctl"), "o", "a", "r"],
                   verbose=False)
    ctl.kernel = "exact"
    ctl.tblbase = str(d / "synth")
    obs = read_obs(d / "obs.tab", ctl)
    atm = read_atm(d / "atm.tab", ctl)
    obs.rad[2, 1] = np.nan
    fm = ForwardModel(ctl, directory=str(d))
    fm.formod(atm, obs)
    assert np.isnan(obs.rad[2, 1])
    assert np.isfinite(obs.rad[2, 0])
    assert np.isfinite(obs.rad[3, 1])
