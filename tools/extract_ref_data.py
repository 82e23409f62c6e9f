#!/usr/bin/env python3
"""Extract embedded physical data tables from the reference C sources into .npz.

The reference (slcs-jsc/jurassic-gpu) embeds climatological profiles and
continuum-absorption coefficient tables as C array initializers that are
``#include``-d into functions:

  * ``src/climatology.tbl``  — midlatitude climatology, 0–120 km, 27 gases
    (used by ``climatology()``, jurassic.c:79-140)
  * ``src/ctmco2.tbl``       — CO2 continuum, 3 temperatures x 2001 wavenumbers
    (used by ``continua_ctmco2``, jr_common.h:316-331)
  * ``src/ctmh2o.tbl``       — H2O continuum self/foreign, 2001 wavenumbers
    (used by ``continua_ctmh2o``, jr_common.h:334-362)
  * ``src/ctmn2.tbl``        — N2 continuum, 98 pts over 2120–2605 cm^-1
    (used by ``continua_ctmn2``, jr_common.h:365-376)
  * ``src/ctmo2.tbl``        — O2 continuum, 90 pts over 1360–1805 cm^-1
    (used by ``continua_ctmo2``, jr_common.h:379-390)

These are physical data (measured/compiled spectroscopic coefficients), not
code. We parse the initializers with a small regex scanner and store them as
compressed .npz files under ``jurassic_tpu/data/`` so the package is fully
standalone. Run this script only to regenerate the .npz files from a reference
checkout; the outputs are committed.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

import numpy as np

REF = Path(sys.argv[1] if len(sys.argv) > 1 else "/root/reference/src")
OUT = Path(__file__).resolve().parent.parent / "jurassic_tpu" / "data"

ARRAY_RE = re.compile(
    r"static\s+double\s+const\s+\(?(\w+)\)?\s*\[(\d+)\]\s*=\s*\{(.*?)\}\s*;",
    re.DOTALL,
)


def parse_c_arrays(path: Path) -> dict[str, np.ndarray]:
    text = path.read_text()
    out = {}
    for name, n, body in ARRAY_RE.findall(text):
        vals = np.array([float(tok) for tok in body.replace("\n", " ").split(",")])
        assert vals.size == int(n), (name, vals.size, n)
        out[name] = vals
    return out


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)

    clim = parse_c_arrays(REF / "climatology.tbl")
    # z, pre, tem plus one array per gas (lowercase names in the C source).
    np.savez_compressed(OUT / "climatology.npz", **clim)
    print(f"climatology.npz: {sorted(clim)}")

    co2 = parse_c_arrays(REF / "ctmco2.tbl")
    h2o = parse_c_arrays(REF / "ctmh2o.tbl")
    n2 = parse_c_arrays(REF / "ctmn2.tbl")
    o2 = parse_c_arrays(REF / "ctmo2.tbl")
    np.savez_compressed(
        OUT / "continua.npz",
        co2296=co2["co2296"], co2260=co2["co2260"], co2230=co2["co2230"],
        h2o296=h2o["h2o296"], h2o260=h2o["h2o260"], h2ofrn=h2o["h2ofrn"],
        n2_b=n2["ba"], n2_beta=n2["betaa"],
        o2_b=o2["ba"], o2_beta=o2["betaa"],
    )
    for k, v in [("co2", co2), ("h2o", h2o), ("n2", n2), ("o2", o2)]:
        print(f"{k}: {sorted((n, a.size) for n, a in v.items())}")


if __name__ == "__main__":
    main()
