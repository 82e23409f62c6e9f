#!/usr/bin/env python3
"""Measure the reference CPU binary's forward-model throughput.

Runs the locally compiled reference (tools/build_reference.sh) on the
workload-matched bench.py configuration -- identical synthetic tables
(--grid bench, the 40x30x224 grid from models/synthetic.py), identical
1084-ray limb scan (Z0 3 Z1 68 DZ 0.06), 100 channels, 4 gases, default
RAYDS=10/RAYDZ=0.5 -- and records rays*channels/s into
BENCH_BASELINE.json (a CPU measurement of the C binary on this host).

Methodology: the reference timing harness is compile-time-gated
(BENCHMARK_FORMOD, formod.c:71-181), so we measure at the process level
and subtract fixed overhead (table load from the binary cache, I/O) via
a 2-ray null run: throughput = (R-2)*D / (t_full - t_null), best of
``--repeats``.  OpenMP uses all cores (the reference's own CPU
parallelism, CPUdrivers.c:91-95).
"""
import argparse
import json
import os
import platform
import subprocess
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).parent
REPO = HERE.parent
BIN = HERE / "ref_build" / "bin"


def run(cmd, cwd, env=None):
    t0 = time.perf_counter()
    subprocess.run(cmd, cwd=cwd, check=True, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL, env=env)
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=100)
    ap.add_argument("--gases", nargs="+",
                    default=["CO2", "H2O", "O3", "F11"])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    if not (BIN / "formod").exists():
        subprocess.run([str(HERE / "build_reference.sh")], check=True)

    work = HERE / "ref_bench"
    work.mkdir(exist_ok=True)
    nu = np.linspace(700.0, 1200.0, args.channels)

    subprocess.run(
        ["python3", str(HERE / "make_synthetic_tables.py"), str(work),
         "--tblbase", "synth", "--grid", "bench", "--gases", *args.gases,
         "--channels", *[f"{x:.4f}" for x in nu]],
        check=True, stdout=subprocess.DEVNULL)

    ctl = ["TBLBASE = ./synth", f"NG = {len(args.gases)}"]
    ctl += [f"EMITTER[{i}] = {g}" for i, g in enumerate(args.gases)]
    ctl += [f"ND = {args.channels}"]
    ctl += [f"NU[{i}] = {x:.4f}" for i, x in enumerate(nu)]
    ctl += ["WRITE_BINARY = 1", "READ_BINARY = -1", "USEGPU = 0"]
    (work / "bench.ctl").write_text("\n".join(ctl) + "\n")

    env = dict(os.environ, OMP_NUM_THREADS=str(os.cpu_count()))
    run([str(BIN / "climatology"), "bench.ctl", "atm.tab"], work, env)
    # limb scan, NR_max-ish rays: tangent alts 3..68 at fine steps
    run([str(BIN / "limb"), "bench.ctl", "obs_full.tab",
         "Z0", "3", "Z1", "68", "DZ", "0.06"], work, env)
    run([str(BIN / "limb"), "bench.ctl", "obs_null.tab",
         "Z0", "3", "Z1", "68", "DZ", "65"], work, env)
    nr_full = sum(1 for ln in (work / "obs_full.tab").read_text()
                  .splitlines() if ln.strip() and not ln.startswith("#"))
    nr_null = sum(1 for ln in (work / "obs_null.tab").read_text()
                  .splitlines() if ln.strip() and not ln.startswith("#"))

    # first run parses ASCII tables + writes the binary cache: not timed
    run([str(BIN / "formod"), "bench.ctl", "obs_null.tab", "atm.tab",
         "rad_null.tab"], work, env)

    best = None
    for _ in range(args.repeats):
        t_full = run([str(BIN / "formod"), "bench.ctl", "obs_full.tab",
                      "atm.tab", "rad_full.tab"], work, env)
        t_null = run([str(BIN / "formod"), "bench.ctl", "obs_null.tab",
                      "atm.tab", "rad_null.tab"], work, env)
        if t_full > t_null:
            thr = (nr_full - nr_null) * args.channels / (t_full - t_null)
            best = max(best or 0.0, thr)
    assert best, "reference timing produced no usable sample"

    out = {
        "ref_rays_channels_per_s": round(best, 1),
        "rays": nr_full, "channels": args.channels,
        "gases": args.gases,
        "omp_threads": os.cpu_count(),
        "host": platform.platform(),
        "method": ("best-of-N process-level (t_full - t_null); "
                   "binary table cache pre-warmed"),
    }
    (REPO / "BENCH_BASELINE.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
