"""refspec window batch driver end to end.

Drives the loop body of example/refspec/run.sh (mirroring the
reference's example/refspec/run.sh:7-29) as one pipeline --
climatology -> limb -> formod -> obs2spec -- through the actual CLI
entry points, and compares the final artifacts (rad_<nu>.tab and
spec.rad_<nu>.tab) against goldens produced by the locally compiled
reference binaries on identical synthetic tables
(tools/make_goldens.sh, refspec section).
"""
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

GOLD = Path(__file__).parent / "goldens" / "refspec"
TOOLS = Path(__file__).parent.parent / "tools"
NU0 = 790


@pytest.fixture(scope="module")
def refspec_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("refspec")
    shutil.copy(GOLD / "template.ctl", d / "template.ctl")
    channels = [f"{NU0 + i:.4f}" for i in range(100)]
    subprocess.run(
        [sys.executable, str(TOOLS / "make_synthetic_tables.py"), str(d),
         "--tblbase", "synth", "--gases", "CO2", "H2O", "O3",
         "--channels", *channels],
        check=True, stdout=subprocess.DEVNULL)
    return d


def test_refspec_window_pipeline(refspec_dir, monkeypatch, capsys):
    """One 100-channel window: the full four-stage CLI pipeline must
    reproduce the reference driver's outputs."""
    from jurassic_tpu.cli import climatology, formod, limb, obs2spec

    d = refspec_dir
    monkeypatch.chdir(d)
    # the run.sh loop body: template + appended NU[] lines
    ctl = d / f"limb_{NU0}.ctl"
    lines = (GOLD / "template.ctl").read_text()
    lines += "".join(f"NU[{i}] = {NU0 + i}\n" for i in range(100))
    ctl.write_text(lines)

    assert climatology.main(["climatology", str(ctl), "atm.tab"]) in (0, None)
    assert limb.main(["limb", str(ctl), "obs.tab",
                      "Z0", "6", "Z1", "66", "DZ", "6.0"]) in (0, None)
    assert formod.main(["formod", str(ctl), "obs.tab", "atm.tab",
                        f"rad_{NU0}.tab", "KERNEL", "exact"]) in (0, None)
    assert obs2spec.main(["obs2spec", str(ctl), f"rad_{NU0}.tab",
                          f"spec.rad_{NU0}.tab"]) in (0, None)

    got = np.loadtxt(d / f"rad_{NU0}.tab")
    ref = np.loadtxt(GOLD / f"rad_{NU0}.tab")
    assert got.shape == ref.shape
    nd = 100
    rad_ref = ref[:, 10:10 + nd]
    scale = np.abs(rad_ref).max()
    # %g print floor (6 significant digits) over the exact kernel
    assert np.abs(got[:, 10:10 + nd] - rad_ref).max() <= 5e-6 * scale
    assert np.abs(got[:, 10 + nd:10 + 2 * nd]
                  - ref[:, 10 + nd:10 + 2 * nd]).max() <= 2e-6

    spec = np.loadtxt(d / f"spec.rad_{NU0}.tab")
    spec_ref = np.loadtxt(GOLD / f"spec.rad_{NU0}.tab")
    assert spec.shape == spec_ref.shape
    # geometry/frequency columns print-identical; radiance to the floor
    np.testing.assert_allclose(spec[:, :11], spec_ref[:, :11],
                               rtol=1e-6, atol=1e-4)
    assert np.abs(spec[:, 11] - spec_ref[:, 11]).max() <= 5e-6 * scale


def test_refspec_wide_window_batching(refspec_dir):
    """Window batching: the reference drives its spectral sweep as
    fixed 100-channel windows because ND is a compile-time cap
    (jurassic.h:141, example/refspec/run.sh:7-14).  Runtime shapes
    remove the cap: ONE wide call over the union of windows must equal
    the concatenation of the narrow window runs (channels carry no
    cross-channel state)."""
    from jurassic_tpu.config import read_ctl
    from jurassic_tpu.forward import ForwardModel
    from jurassic_tpu.io_tab import read_atm, read_obs

    from jurassic_tpu.cli import climatology, limb

    d = refspec_dir
    base = (GOLD / "template.ctl").read_text()
    if not (d / "obs.tab").exists():      # self-sufficient when run alone
        ctl0 = d / "geom.ctl"
        ctl0.write_text(base.replace("ND = 100", "ND = 1")
                        + f"NU[0] = {NU0}\n")
        climatology.main(["climatology", str(ctl0), str(d / "atm.tab")])
        limb.main(["limb", str(ctl0), str(d / "obs.tab"),
                   "Z0", "6", "Z1", "66", "DZ", "6.0"])

    def run(ctl_lines, nd):
        ctl = d / f"wide_{nd}_{hash(ctl_lines) & 0xffff}.ctl"
        ctl.write_text(ctl_lines)
        c = read_ctl(["formod", str(ctl), "obs.tab", "atm.tab", "rad"],
                     verbose=False)
        c.kernel = "jax"
        c.tblbase = str(d / "synth")
        obs = read_obs(d / "obs.tab", c)
        atm = read_atm(d / "atm.tab", c)
        ForwardModel(c, directory=str(d)).formod(atm, obs)
        return obs

    b50 = base.replace("ND = 100", "ND = 50")
    lo = b50 + "".join(f"NU[{i}] = {NU0 + i}\n" for i in range(50))
    hi = b50 + "".join(f"NU[{i}] = {NU0 + 50 + i}\n" for i in range(50))
    wide = base + "".join(f"NU[{i}] = {NU0 + i}\n" for i in range(100))
    obs_lo, obs_hi, obs_w = run(lo, 50), run(hi, 50), run(wide, 100)
    np.testing.assert_allclose(
        obs_w.rad, np.concatenate([obs_lo.rad, obs_hi.rad], axis=1),
        rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        obs_w.tau, np.concatenate([obs_lo.tau, obs_hi.tau], axis=1),
        rtol=1e-12, atol=0)
