"""JURASSIC forward model CLI (mirror of formod.c).

Usage: ``jurassic-formod <ctl> <obs> <atm> <rad> [NAME value ...]``

The reference's BENCHMARK_FORMOD block (formod.c:71-181) is available at
runtime instead of compile time: pass ``BENCH 1`` (iterations come from
``USEGPU``^2 like the reference's useGPU^2) or ``BENCH <n>`` for an
explicit count, with the same repeat-run deviation gate before timings
are reported (formod.c:106-166).
"""
from __future__ import annotations

import sys
import time

import numpy as np

from ..forward import ForwardModel
from ..io_tab import read_atm, read_obs, write_obs
from ..utils import profile_trace, timer
from ._common import cli_main, load_ctl


def _compare_runs(ctl, obs_ref, obs_bench) -> int:
    """Element-wise repeat-run comparison (formod.c:106-159): per-ray and,
    on deviation, per-channel max-abs reports.  Returns the number of
    deviating views (0 = bitwise reproducible)."""
    rad_or_bt = ("brightness temperature" if ctl.write_bbt else "radiance")
    deviations = 0
    for axis, which in ((1, "ray"), (0, "channel")):
        dev_tau = np.nan_to_num(obs_bench.tau - obs_ref.tau)
        dev_rad = np.nan_to_num(obs_bench.rad - obs_ref.rad)
        ndev_t = np.sum(np.any(dev_tau != 0, axis=axis))
        ndev_r = np.sum(np.any(dev_rad != 0, axis=axis))
        for name, dev, ndev in (("transmittance", dev_tau, ndev_t),
                                (rad_or_bt, dev_rad, ndev_r)):
            per = np.max(np.abs(dev), axis=axis)
            for i in np.nonzero(per)[0]:
                print(f"# deviations in {name} in {which} #{i}, "
                      f"largest {per[i]:.1e}")
        if ndev_t > 0 or ndev_r > 0:
            deviations += 1
        if deviations == 0:
            break  # transposed report only when the first pass deviates
    print(f"# Compare obs-results: {rad_or_bt} and transmittance for "
          f"{obs_ref.nr} rays times {ctl.nd} channels shows"
          f"{'' if deviations else ' no'} deviations")
    return deviations


@cli_main
def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    ctl, s = load_ctl(argv, 5, "<ctl> <obs> <atm> <rad>")
    obs = read_obs(argv[2], ctl)
    atm = read_atm(argv[3], ctl)

    if ctl.checkmode:
        # dry-run validation (jurassic.c:401-413, 654): report the table
        # filename patterns per gas and validate the filter files open
        from ..geometry import hydrostatic_atm
        from ..tables import tables_checkmode
        tables_checkmode(ctl, ".")
        hydrostatic_atm(ctl, atm)
        print(f"# formod: checkmode = {ctl.checkmode}, "
              "no actual computation is performed!")
        write_obs(argv[4], ctl, obs)
        return 0
    profile_dir = s.scan("PROFILE", -1, "-")
    with profile_trace(None if profile_dir == "-" else profile_dir):
        # phase timers (TIMER stack, jurassic.c:1224-1246; the reference
        # times table init, jurassic.c:322,417, and warm-up, formod.c:64)
        timer("INIT_MODEL", 1)
        fm = ForwardModel(ctl)
        timer("INIT_MODEL", 3)
        timer("WARM-UP", 1)
        fm.formod(atm, obs)
        timer("WARM-UP", 3)
    write_obs(argv[4], ctl, obs)

    if s.scan_int("BENCH_SCALING", -1, "0"):
        # power-of-2 nr x nd scaling sweep
        # (BENCH_FORMOD_SCALING_TESTS, formod.c:84-92)
        import dataclasses
        nd = 1
        while nd <= ctl.nd:
            print(f"# with channels\n# with {nd} channels measure "
                  "formod time")
            ctl_b = dataclasses.replace(
                ctl, nd=nd, nu=list(ctl.nu[:nd]),
                window=list(ctl.window[:nd]))
            fm_b = ForwardModel(ctl_b)
            nr = 1
            while nr <= obs.nr:
                obs_b = obs.copy()
                for f in dataclasses.fields(obs_b):
                    v = getattr(obs_b, f.name)[:nr]
                    setattr(obs_b, f.name, v[:, :nd] if v.ndim > 1 else v)
                print(f"\nscaling test: runs with {nr} rays and {nd} "
                      "channels")
                fm_b.formod(atm.copy(), obs_b)       # warm-up/compile
                t0 = time.perf_counter()
                fm_b.formod(atm.copy(), obs_b)
                dt = time.perf_counter() - t0
                print(f"# with {nr} rays and {nd} channels formod took "
                      f"{dt:g} seconds ({nr * nd / dt:.1f} rays*ch/s)")
                nr *= 2
            nd *= 2
        return 0

    bench = s.scan_int("BENCH", -1, "0")
    if bench:
        niter = max(1, ctl.usegpu * ctl.usegpu) if bench == 1 else bench
        if niter > 1:
            print(f"# always run {niter} iterations for benchmarking")
        times = []
        deviations = 0
        for it in range(niter):
            obs_b = obs.copy()
            t0 = time.perf_counter()
            fm.formod(atm, obs_b)
            times.append(time.perf_counter() - t0)
            if it == 0:
                deviations = _compare_runs(ctl, obs, obs_b)
            if deviations:
                break
        if deviations:
            print(f"# timing results are not shown due to deviations "
                  f"({deviations}) in obs-results!")
        else:
            mean = float(np.mean(times))
            sigma = float(np.std(times))
            print(f"# with {obs.nr} rays and {ctl.nd} channels formod took "
                  f"{mean:g} +/- {sigma:g} seconds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
