#!/usr/bin/env python3
"""Generate synthetic emissivity-growth tables in the reference ASCII
format (init_tbl, jurassic.c:311-416 expects 4-column rows
``press temp u eps`` with ascending pressure blocks, ascending
temperature sub-blocks, and jointly increasing (u, eps) entries).

The real LUT blobs are stripped from the reference mount
(.MISSING_LARGE_BLOBS); these analytic tables provide a blob-independent
oracle: both the locally-built reference CPU binary and jurassic_tpu run
on the *same* tables, so their radiances must agree to float tolerance
regardless of the tables' physical fidelity.

Model: eps(p, T, u) = 1 - exp(-(sigma(p, T) * u)^0.9) with
sigma = s0 * (p/p0)^0.3 * (250/T)^0.7, s0 chosen per (gas, channel) so the
transition happens inside realistic column densities.  The u grid is
geometric with ratio 2^(1/6), matching the documented layout of the real
tables (FAST_INVERSE_OF_U, jurassic.c:518-530).
"""
import argparse
import sys
from pathlib import Path

import numpy as np

GAS_S0 = {  # base cross-section scale per gas [cm^2/molec]-ish
    "CO2": 3e-22, "H2O": 8e-22, "O3": 5e-21, "F11": 2e-20, "CCl4": 1e-20,
}


def sigma(s0, p, t):
    return s0 * (p / 1013.25) ** 0.3 * (250.0 / t) ** 0.7


def write_table(path: Path, s0: float, nu: float):
    p_grid = np.logspace(-2, 3, 12)            # ascending [hPa]
    t_offsets = np.linspace(-60.0, 60.0, 7)    # around a p-dependent mean
    ch = 1.0 + 0.1 * np.sin(nu)               # channel-dependent factor
    lines = []
    for p in p_grid:
        tmean = 230.0 + 30.0 * np.tanh(np.log10(p))
        for t in tmean + t_offsets:
            # geometric u grid covering the eps in [1e-6, 1-1e-6] range
            s = sigma(s0 * ch, p, t)
            u0 = 1e-6 / s
            n = 1 + int(np.ceil(np.log2(1e7) / (1.0 / 6.0)))
            u = u0 * 2.0 ** (np.arange(n) / 6.0)
            eps = 1.0 - np.exp(-((s * u) ** 0.9))
            for uu, ee in zip(u, eps):
                if ee >= 1.0:
                    break
                lines.append(f"{p:.6e} {t:.6e} {uu:.6e} {ee:.6e}")
    path.write_text("\n".join(lines) + "\n")


def write_filter(path: Path, nu: float):
    grid = nu + np.linspace(-1.5, 1.5, 7)
    w = np.array([0.2, 0.6, 0.9, 1.0, 0.9, 0.6, 0.2])
    path.write_text(
        "\n".join(f"{x:.4f} {y:.3f}" for x, y in zip(grid, w)) + "\n")


def write_table_bench(path: Path, gas_index: int, s0: float, nu: float,
                      n_p: int = 40, n_t: int = 30, n_k: int = 224):
    """Benchmark-grid table, bit-matching the physics of
    jurassic_tpu.models.synthetic.synthetic_fast_tables so the reference
    binary and this package can be benchmarked on identical tables
    (VERDICT round-1 item 2: workload-matched baseline)."""
    p_grid = np.logspace(np.log10(3e-3), np.log10(1013.25), n_p)
    t_grid = np.linspace(160.0, 330.0, n_t)
    spec = 0.25 + 1.5 * abs(np.sin(nu / 97.0 + (gas_index + 1)))
    k = np.arange(n_k)
    su = 3e-4 * np.exp2(k / 6.0)
    eps = 1.0 - np.exp(-np.power(su, 0.9))
    ncut = int(np.searchsorted(eps, 1.0))        # reference parser
    eps = eps[:max(ncut, 2)]                     # overwrites eps >= 1 rows
    kcut = k[:max(ncut, 2)]
    lines = []
    for p in p_grid:
        for t in t_grid:
            sig = sigma(s0 * spec, p, t)
            u = (3e-4 / sig) * np.exp2(kcut / 6.0)
            for uu, ee in zip(u, eps):
                lines.append(f"{p:.9e} {t:.9e} {uu:.9e} {ee:.9e}")
    path.write_text("\n".join(lines) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir", type=Path)
    ap.add_argument("--tblbase", default="synth")
    ap.add_argument("--gases", nargs="+", default=["CO2", "H2O", "O3"])
    ap.add_argument("--channels", nargs="+", type=float,
                    default=[792.0, 832.0])
    ap.add_argument("--grid", choices=["golden", "bench"], default="golden",
                    help="golden: small 12x7 grid; bench: the 40x30x224 "
                         "benchmark grid matching synthetic_fast_tables")
    args = ap.parse_args(argv)
    args.outdir.mkdir(parents=True, exist_ok=True)
    for nu in args.channels:
        write_filter(args.outdir / f"{args.tblbase}_{nu:.4f}.filt", nu)
        for ig, gas in enumerate(args.gases):
            s0 = GAS_S0.get(gas, 1e-21)
            fn = args.outdir / f"{args.tblbase}_{nu:.4f}_{gas}.tab"
            if args.grid == "bench":
                write_table_bench(fn, ig, s0, nu)
            else:
                write_table(fn, s0, nu)
    print(f"synthetic tables written to {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
