#!/usr/bin/env python3
"""Bring-up check of the forward model on NVIDIA GPUs.

Drives the main path -- ``ForwardModel.formod`` and the ``formod`` CLI --
on the card at full width and checks every result against the repo's
own references.  Every phase raises on failure, so the script exits
non-zero; only when all phases pass is the last line of standard output

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage, from the root of a checkout:

    python chip_smoke.py               one card, phases 1-6
    python chip_smoke.py --four-cards  the four-card phase only

Phases (one card):
  1. device      every JAX device is a GPU; nothing runs on the CPU
  2. goldens     the C-oracle golden cases of tests/goldens through the
                 formod CLI, with the fused kernel and the jnp fast path
  3. flagship    1084 limb rays x 100 channels x 4 gases, NLOS 400:
                 repeat-run bitwise gate, kernel and XLA-scan rates, and
                 the f64 jnp reference on the host CPU of this process
  4. batch       the flagship scan tiled to 10,840 rays through RAYPACK
                 auto-sizing; every ray matches its flagship twin
  5. jacobian    retrieval.kernel_autodiff against the FD retrieval.kernel
  6. card tests  the tests marked ``gpu`` (tests/test_gpu.py)

Tolerances and their reasons:
  * goldens, kernel and jnp fast path: 2e-3 x scale on radiance, 2e-3 on
    transmittance -- the fast tables' log-uniform resampling against the
    C oracle's own u grid (the tests' bar); float32 adds < 1e-4.
  * flagship vs the f64 reference: 5e-4 x scale / 5e-4 -- float32 ray
    tracing and accumulation over up to 400 LOS steps (the same
    float32-vs-float64 gap of the jnp pipeline is ~1.1e-4 on a CPU).
  * kernel vs XLA's scan on the card: 1e-5 x scale / 1e-5 -- the same
    float32 arithmetic in another order (tests/test_pallas_kernel.py).
    No matrix product is on the device path, so TF32 cannot arise; the
    flagship phase checks the compiled tracer and both integration
    steps for dot and convolution instructions.
  * tiled batch vs flagship twin: 1e-6 relative (same per-ray program).
  * Jacobian: atol 2e-2 x scale, rtol 0.05 -- FD truncation
    (tests/test_retrieval.py).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLD = REPO / "tests" / "goldens"
FLAGSHIP_RAYS = 1084
BATCH_RAYS = 10840
JACOBIAN_RAYS, JACOBIAN_CHANNELS = 64, 100


class PhaseError(AssertionError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseError(msg)


def report(name: str, err: float, limit: float, what: str = "") -> None:
    """Print one error against its limit; raise when it is over."""
    print(f"#   {name}: {what}{err:.3e} (limit {limit:.1e})", flush=True)
    check(bool(err <= limit), f"{name}: {err:g} > {limit:g}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip()


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def copy_obs(obs):
    from jurassic_tpu.io_tab import Obs
    return Obs(**{f.name: np.array(getattr(obs, f.name))
                  for f in dataclasses.fields(Obs)})


# ---------------------------------------------------------------------------
# Phase 1

def phase_device():
    import jax
    devs = jax.devices()
    print(f"# jax.devices(): {devs}", flush=True)
    bad = [d for d in devs if d.platform != "gpu"]
    if bad:
        print(f"chip_smoke: JAX finds no GPU ({bad}); refusing to run",
              file=sys.stderr)
        sys.exit(2)
    return devs


# ---------------------------------------------------------------------------
# Phase 2

GOLDEN_CASES = {
    # case: (ctl file, golden radiance file, per-band channel slices)
    "limb": ("limb.ctl", "rad.tab", None),
    "nadir": ("nadir.ctl", "rad.tab", None),
    "ega": ("ega.ctl", "rad.tab", None),
    "flagship": ("flagship.ctl", "rad.tab",
                 (slice(0, 40), slice(40, 70), slice(70, 100))),
    "gas30": ("gas30.ctl", "rad.tab", "per-channel"),
    "fov": ("limb.ctl", "rad_fov.tab", None),
}


def _golden_workdir(case: str, root: Path) -> Path:
    """The golden case in a work directory, with the synthetic tables
    that the committed flagship and gas30 cases regenerate."""
    from jurassic_tpu.config import read_ctl
    d = root / case
    shutil.copytree(GOLD / case, d)
    ctl_file = d / GOLDEN_CASES[case][0]
    if case in ("flagship", "gas30"):
        ctl = read_ctl(["x", str(ctl_file), "o", "a", "r"], verbose=False)
        gases = [g for g in ctl.emitter[:ctl.ng] if g not in ("N2", "O2")]
        tool = load_module(REPO / "tools" / "make_synthetic_tables.py",
                           "make_synthetic_tables")
        with contextlib.redirect_stdout(io.StringIO()):
            tool.main([str(d), "--tblbase", "synth", "--gases", *gases,
                       "--channels", *[f"{x:.4f}" for x in ctl.nu]])
    return d


def _compare_golden(case, d, out_file, kernel):
    from jurassic_tpu.config import read_ctl
    ctl = read_ctl(["x", str(d / GOLDEN_CASES[case][0]), "o", "a", "r"],
                   verbose=False)
    nd = ctl.nd
    ref = np.loadtxt(d / GOLDEN_CASES[case][1])
    got = np.loadtxt(out_file)
    rad_ref, tau_ref = ref[:, 10:10 + nd], ref[:, 10 + nd:10 + 2 * nd]
    rad, tau = got[:, 10:10 + nd], got[:, 10 + nd:10 + 2 * nd]
    bands = GOLDEN_CASES[case][2]
    if bands == "per-channel":
        err = float((np.abs(rad - rad_ref).max(axis=0)
                     / np.abs(rad_ref).max(axis=0)).max())
    else:
        err = max(float(np.abs(rad[:, sl] - rad_ref[:, sl]).max()
                        / np.abs(rad_ref[:, sl]).max())
                  for sl in (bands or (slice(None),)))
    report(f"golden {case} KERNEL {kernel} rad", err, 2e-3,
           "max abs / scale ")
    report(f"golden {case} KERNEL {kernel} tau",
           float(np.abs(tau - tau_ref).max()), 2e-3, "max abs ")


def phase_goldens():
    from jurassic_tpu.cli.formod import main as formod_cli
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        try:
            for case in GOLDEN_CASES:
                d = _golden_workdir(case, Path(tmp))
                os.chdir(d)
                for kernel in ("auto", "jax"):
                    out_file = d / f"rad_{kernel}.tab"
                    log = io.StringIO()
                    t0 = time.perf_counter()
                    try:
                        with contextlib.redirect_stdout(log):
                            rc = formod_cli(
                                ["formod", GOLDEN_CASES[case][0], "obs.tab",
                                 "atm.tab", str(out_file), "USEGPU", "1",
                                 "KERNEL", kernel])
                    except SystemExit as e:
                        rc = e.code
                    if rc != 0:
                        print(log.getvalue()[-3000:])
                    check(rc == 0, f"formod CLI {case} {kernel}: rc {rc}")
                    print(f"# golden {case}: formod CLI KERNEL {kernel} "
                          f"{time.perf_counter() - t0:.1f} s", flush=True)
                    _compare_golden(case, d, out_file, kernel)
        finally:
            os.chdir(cwd)


# ---------------------------------------------------------------------------
# Phase 3

def _reference_f64(ctl, ft, atm, obs):
    """The plain reference: the jnp fast path in float64 on this
    process's host CPU backend (no second process opens the card)."""
    import jax
    import jax.numpy as jnp
    from jurassic_tpu.forward import ForwardModel
    ref_ctl = dataclasses.replace(ctl, kernel="jax", usegpu=0)
    with jax.enable_x64(True):
        model = ForwardModel(ref_ctl, fast_tables=ft, dtype=jnp.float64)
        check(model.exec_device is not None
              and model.exec_device.platform == "cpu",
              "the f64 reference must run on the host CPU")
        return model.formod(atm.copy(), copy_obs(obs))


MATMUL_OPS = (" dot(", " convolution(", "cublas", "gemm")


def _matmul_ops(compiled) -> list[str]:
    text = compiled.as_text()
    return [op.strip() for op in MATMUL_OPS if op in text]


def check_no_matmul(model, xla, atm, obs):
    """The compiled device path holds no matrix product, so float32
    never runs in TF32 on this card."""
    import jax.numpy as jnp
    from jurassic_tpu.forward import rt_integrate, rt_integrate_fused
    from jurassic_tpu.geometry import _trace_rays_jit, build_ray_profiles
    ctl = model.ctl
    prof = build_ray_profiles(ctl, atm.copy(), obs, model.dtype)
    geo = {k: jnp.asarray(getattr(obs, k), model.dtype)
           for k in ("obsz", "obslon", "obslat", "vpz", "vplon", "vplat")}
    los = model.trace(atm.copy(), copy_obs(obs))
    steps = {
        "tracer": _trace_rays_jit.lower(
            prof, geo, float(ctl.rayds), float(ctl.raydz),
            bool(ctl.refrac), int(ctl.nlos), model.dtype),
        "kernel step": rt_integrate_fused.lower(
            model.dev_tbl, model.kernel_axes, model.cc_rows, model.sr,
            model.st, model.nu, los, los.tsurf, model.flags, model.ig_co2,
            model.ig_h2o, bool(ctl.write_bbt), False),
        "XLA scan step": rt_integrate.lower(
            xla.dev_tbl, xla.sr, xla.st, xla.nu, xla.cc, xla.window, los,
            los.tsurf, xla.flags, xla.ig_co2, xla.ig_h2o, True,
            bool(ctl.write_bbt)),
    }
    for name, lowered in steps.items():
        ops = _matmul_ops(lowered.compile())
        print(f"#   {name}: matrix products in the compiled HLO: "
              f"{ops or 'none'}", flush=True)
        check(not ops, f"{name} compiles to {ops}: float32 could run "
                       "in TF32")


def phase_flagship(bench, card):
    from jurassic_tpu.forward import ForwardModel
    ctl, ft, atm, obs = bench.build_workload()
    check(obs.nr == FLAGSHIP_RAYS, f"flagship has {obs.nr} rays")
    ctl.kernel = "auto"
    model = ForwardModel(ctl, fast_tables=ft)
    print(f"# dispatch: KERNEL auto -> {model.kernel_mode} "
          f"(platform {model.platform}, interpret {model.interpret})",
          flush=True)
    check(model.kernel_mode == "pallas" and not model.interpret,
          "KERNEL auto must take the compiled kernel on the GPU")
    rad0, _ = bench.time_formod(model, atm, obs, 1)      # compile
    rad1, _ = bench.time_formod(model, atm, obs, 1)
    report("flagship repeat-run deviation", float(np.abs(rad1 - rad0).max()),
           0.0, "max abs ")
    o_ker = copy_obs(obs)
    model.formod(atm.copy(), o_ker)
    _, dt_ker = bench.time_formod(model, atm, obs, 5)

    ctl_x = dataclasses.replace(ctl, kernel="jax")
    xla = ForwardModel(ctl_x, fast_tables=ft)
    o_xla = copy_obs(obs)
    xla.formod(atm.copy(), o_xla)
    _, dt_xla = bench.time_formod(xla, atm, obs, 5)
    check_no_matmul(model, xla, atm, obs)
    del xla
    n = obs.nr * ctl.nd
    print(f"# flagship rays*ch/s on {card}: kernel (pallas) {n / dt_ker:.1f} "
          f"({dt_ker:.6f} s/call), XLA scan (jax) {n / dt_xla:.1f} "
          f"({dt_xla:.6f} s/call)", flush=True)
    scale = float(np.abs(o_xla.rad).max())
    report("flagship kernel vs XLA scan rad",
           float(np.abs(o_ker.rad - o_xla.rad).max()) / scale, 1e-5,
           "max abs / scale ")
    report("flagship kernel vs XLA scan tau",
           float(np.abs(o_ker.tau - o_xla.tau).max()), 1e-5, "max abs ")

    t0 = time.perf_counter()
    ref = _reference_f64(ctl, ft, atm, obs)
    print(f"# f64 reference on the host CPU: {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    scale = float(np.abs(ref.rad).max())
    for name, o in (("kernel", o_ker), ("XLA scan", o_xla)):
        report(f"flagship {name} vs f64 reference rad",
               float(np.abs(o.rad - ref.rad).max()) / scale, 5e-4,
               "max abs / scale ")
        report(f"flagship {name} vs f64 reference tau",
               float(np.abs(o.tau - ref.tau).max()), 5e-4, "max abs ")
    check(np.isfinite(o_ker.rad).all() and o_ker.rad.shape
          == (FLAGSHIP_RAYS, ctl.nd), "flagship output shape/finite")
    del model
    return ctl, ft, atm, obs, o_ker


# ---------------------------------------------------------------------------
# Phase 4

def phase_batch(bench, flagship):
    import jax
    from jurassic_tpu.forward import ForwardModel
    ctl, ft, atm, obs, o_flag = flagship
    big = bench.tile_obs(obs, BATCH_RAYS)
    ctl = dataclasses.replace(ctl, kernel="auto", raypack=0)
    model = ForwardModel(ctl, fast_tables=ft)
    dev = jax.devices()[0]
    pack = model.package_size(big.nr)
    prb = model.per_ray_device_bytes()
    rays = pack or big.nr
    st0 = dev.memory_stats()
    model.formod(atm.copy(), big)
    st = dev.memory_stats()
    print(f"# RAYPACK auto: package {rays} rays "
          f"({'one package' if not pack else f'{-(-big.nr // pack)} packages'})"
          f", model {prb} B/ray = {prb * rays / 1e9:.3f} GB; "
          f"peak_bytes_in_use {st['peak_bytes_in_use'] / 1e9:.3f} GB "
          f"(before the batch {st0['peak_bytes_in_use'] / 1e9:.3f} GB, "
          f"in use after {st['bytes_in_use'] / 1e9:.3f} GB, "
          f"limit {st['bytes_limit'] / 1e9:.3f} GB)", flush=True)
    twin = o_flag.rad[np.arange(big.nr) % obs.nr]
    scale = float(np.abs(twin).max())
    report("batch rays vs flagship twins rad",
           float(np.abs(big.rad - twin).max()) / scale, 1e-6,
           "max abs / scale ")
    check(np.isfinite(big.rad).all(), "batch output finite")


# ---------------------------------------------------------------------------
# Phase 5

def phase_jacobian():
    import jax.numpy as jnp
    from jurassic_tpu.forward import ForwardModel
    from jurassic_tpu.models.synthetic import (limb_workload, synthetic_atm,
                                               synthetic_ctl,
                                               synthetic_fast_tables)
    from jurassic_tpu.retrieval import kernel, kernel_autodiff
    # the retrieval tests' configuration (tests/test_retrieval.py), at
    # JACOBIAN_RAYS rays x JACOBIAN_CHANNELS channels
    ctl = synthetic_ctl(ng=2, nd=JACOBIAN_CHANNELS)
    ctl.nlos = 96
    ctl.rayds, ctl.raydz = 50.0, 5.0
    ctl.rett_zmin, ctl.rett_zmax = 10.0, 30.0
    ctl.retq_zmin = [-999.0, 20.0]
    ctl.retq_zmax = [-999.0, 40.0]
    atm = synthetic_atm(ctl, dz=5.0)
    obs = limb_workload(ctl, JACOBIAN_RAYS)
    model = ForwardModel(ctl, dtype=jnp.float32,
                         fast_tables=synthetic_fast_tables(
                             ctl, n_p=12, n_t=8, n_k=96))
    check(model.kernel_mode == "pallas", "Jacobian FD forward: kernel")
    t0 = time.perf_counter()
    k_fd = kernel(ctl, atm.copy(), copy_obs(obs), model)
    t1 = time.perf_counter()
    k_ad = kernel_autodiff(ctl, atm.copy(), copy_obs(obs), model)
    t2 = time.perf_counter()
    print(f"# Jacobian {k_ad.shape}: FD {t1 - t0:.1f} s, "
          f"jacfwd {t2 - t1:.1f} s", flush=True)
    check(k_fd.shape == k_ad.shape, "Jacobian shapes")
    scale = float(np.abs(k_ad).max())
    check(scale > 0, "Jacobian is zero")
    excess = np.abs(k_fd - k_ad) - (2e-2 * scale + 0.05 * np.abs(k_ad))
    report("Jacobian FD vs autodiff", float(excess.max()) / scale, 0.0,
           "max (|diff| - (2e-2 scale + 0.05 |K|)) / scale ")


# ---------------------------------------------------------------------------
# Phase 6

def phase_card_tests(card_dev):
    sys.path.insert(0, str(REPO / "tests"))
    mod = load_module(REPO / "tests" / "test_gpu.py", "test_gpu")
    names = sorted(n for n in dir(mod) if n.startswith("test_"))
    check(bool(names), "no card-only tests found")
    for name in names:
        t0 = time.perf_counter()
        getattr(mod, name)(card_dev)
        print(f"# card test {name}: passed "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


# ---------------------------------------------------------------------------
# Four cards

def phase_four_cards(bench, devs, card):
    from jurassic_tpu.forward import ForwardModel
    from jurassic_tpu.parallel import ShardedForwardModel, make_mesh
    check(len(devs) >= 4, f"--four-cards needs 4 GPUs, found {len(devs)}")
    ctl, ft, atm, obs = bench.build_workload(rays=BATCH_RAYS)
    ctl.kernel = "auto"
    single = ForwardModel(ctl, fast_tables=ft)
    o1 = copy_obs(obs)
    single.formod(atm.copy(), o1)
    _, dt1 = bench.time_formod(single, atm, obs, 3)
    del single
    mesh = make_mesh(4, 1, devices=devs[:4])
    sharded = ShardedForwardModel(ctl, mesh, fast_tables=ft)
    check(sharded.kernel_mode == "pallas", "sharded path takes the kernel")
    los = sharded.trace(atm.copy(), copy_obs(obs))
    out = sharded.integrate(los)
    for name, arr in (("los.ds", los.ds), ("rad", out.rad)):
        n_dev = len(arr.sharding.device_set)
        print(f"# {name} sharded over {n_dev} devices: {arr.sharding}")
        check(n_dev == 4, f"{name} lands on {n_dev} device(s), not 4")
    o4 = copy_obs(obs)
    sharded.formod(atm.copy(), o4)
    _, dt4 = bench.time_formod(sharded, atm, obs, 3)
    n = obs.nr * ctl.nd
    print(f"# {obs.nr} rays x {ctl.nd} ch on {card}: one card "
          f"{n / dt1:.1f} rays*ch/s ({dt1:.6f} s/call), (4, 1) mesh "
          f"{n / dt4:.1f} rays*ch/s ({dt4:.6f} s/call)", flush=True)
    scale = float(np.abs(o1.rad).max())
    report("four cards vs one card rad",
           float(np.abs(o4.rad - o1.rad).max()) / scale, 1e-6,
           "max abs / scale ")
    report("four cards vs one card tau",
           float(np.abs(o4.tau - o1.tau).max()), 1e-6, "max abs ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)
    devs = phase_device()
    smi = card_line()
    print(smi, flush=True)          # name, power limit as nvidia-smi says
    card = smi.splitlines()[0]
    from jurassic_tpu.platform import enable_compile_cache
    print(f"# compile cache: {enable_compile_cache()}", flush=True)
    bench = load_module(REPO / "bench.py", "bench")
    t0 = time.perf_counter()
    if args.four_cards:
        phases = [("four cards", lambda: phase_four_cards(bench, devs,
                                                          card))]
    else:
        state = {}
        phases = [
            ("goldens", phase_goldens),
            ("flagship", lambda: state.update(
                flagship=phase_flagship(bench, card))),
            ("batch", lambda: phase_batch(bench, state["flagship"])),
            ("jacobian", phase_jacobian),
            ("card tests", lambda: phase_card_tests(devs[0])),
        ]
    for name, fn in phases:
        t = time.perf_counter()
        print(f"# phase {name}", flush=True)
        fn()
        print(f"# phase {name}: ok ({time.perf_counter() - t:.1f} s)",
              flush=True)
    print(f"# all phases ok in {time.perf_counter() - t0:.1f} s on {card}",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
