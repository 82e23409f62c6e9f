#!/usr/bin/env bash
# Wide-window refspec driver: the batched alternative to run.sh.
#
# The reference steps fixed 100-channel windows across the band because
# ND is a compile-time cap (jurassic.h:141, example/refspec/run.sh:7-14).
# This build's shapes are runtime-sized, so the whole sweep batches into
# a few WIDE formod calls, each one kernel launch over every channel.
# Window equivalence is property-tested in
# tests/test_refspec_pipeline.py::test_refspec_wide_window_batching.
#
# Usage: ./run_wide.sh [NU0 NU1 WIDE]   (defaults 650 2350 1024)
set -euo pipefail
cd "$(dirname "$0")"
J="python3 -m jurassic_tpu.cli"
export PYTHONPATH="${PYTHONPATH:-}:$(cd ../.. && pwd)"
NU0=${1:-650}
NU1=${2:-2350}
WIDE=${3:-1024}

for nu in $(seq "$NU0" "$WIDE" "$NU1"); do
    nd=$(( NU1 - nu + 1 < WIDE ? NU1 - nu + 1 : WIDE ))

    # Modify control file: one wide window instead of nd/100 narrow ones
    sed "s/^ND = .*/ND = $nd/" template.ctl > wide_$nu.ctl
    echo "$nu $nd" | awk '{
      for(i=0; i<$2; i++)
        print "NU["i"] = "$1+i
    }' >> wide_$nu.ctl

    # Create atmospheric data file...
    $J.climatology wide_$nu.ctl atm.tab

    # Create observation geometry...
    $J.limb wide_$nu.ctl obs.tab Z0 3 Z1 68 DZ 1.0

    # Call forward model (KERNEL auto: the fused kernel on a GPU)...
    $J.formod wide_$nu.ctl obs.tab atm.tab rad_$nu.tab

    # Convert spectra...
    for f in rad_$nu*; do
        $J.obs2spec wide_$nu.ctl "$f" "spec.$f"
        rm "$f"
    done
done
