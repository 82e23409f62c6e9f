#!/usr/bin/env python3
"""Forward-model benchmark (BENCHMARK_FORMOD analogue, formod.c:71-181).

Workload (the reference baseline's configuration):

* synthetic tables on the 40x30x224 benchmark grid (models/synthetic.py;
  tools/make_synthetic_tables.py --grid bench writes the same tables in
  the ASCII form the reference binary reads);
* the limb scan of ``limb Z0 3 Z1 68 DZ 0.06``: observer 780 km, 1084
  rays; 100 channels, 4 gases;
* reference ray tracing: RAYDS=10 RAYDZ=0.5 (jurassic.c:976-977) and the
  NLOS=400 step budget (jurassic.h:156);
* the timed call is the full forward model: ray tracing, RT integration
  and the transfer of the outputs to the host.

Methodology mirrors the reference harness: warm-up (TIMER("warm-up"),
formod.c:64-66), a repeat-run bitwise gate before any timing
(formod.c:106-166), then the mean over steady-state iterations.

Prints one JSON line per kernel, naming the device it ran on.  Without
``--cpu`` a run that finds no GPU fails.

Extra modes:
  --sweep      nr x nd power-of-2 scaling sweep (formod.c:84-92)
  --weak       sharding overhead on a virtual CPU device mesh (1/2/4/8)
  --multiproc  1-vs-2-process runs through jax.distributed on the CPU
The parents of --weak and --multiproc never start a JAX backend: their
children pin the CPU, so no process but the child opens a device.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).parent


def build_workload(rays=None, channels=100, gases=4, nlos=400):
    from jurassic_tpu.models.geometry_gen import limb_geometry
    from jurassic_tpu.models.synthetic import (synthetic_atm, synthetic_ctl,
                                               synthetic_fast_tables)
    ctl = synthetic_ctl(ng=gases, nd=channels)
    ctl.nlos = nlos          # reference compile default NLOS=400
    ctl.rayds = 10.0         # reference defaults (jurassic.c:976-977)
    ctl.raydz = 0.5
    ft = synthetic_fast_tables(ctl)
    atm = synthetic_atm(ctl)
    obs = limb_geometry(z0=3.0, z1=68.0, dz=0.06, nd=ctl.nd)
    if rays is not None and rays != obs.nr:
        obs = tile_obs(obs, rays)
    return ctl, ft, atm, obs


def tile_obs(obs, rays):
    """The scan repeated to ``rays`` rays."""
    from jurassic_tpu.io_tab import Obs
    reps = max(1, -(-rays // obs.nr))
    return Obs(**{
        f.name: np.tile(np.asarray(getattr(obs, f.name)),
                        (reps,) + (1,) * (getattr(obs, f.name).ndim - 1)
                        )[:rays]
        for f in dataclasses.fields(Obs)})


def copy_obs(obs):
    from jurassic_tpu.io_tab import Obs
    return Obs(**{f.name: np.array(getattr(obs, f.name))
                  for f in dataclasses.fields(Obs)})


def time_formod(model, atm, obs, iters):
    """Full forward model per iteration; returns (rad of last run, s/iter).
    A fresh obs copy per run keeps the workload identical (formod fills
    rad/tau in place)."""
    t0 = time.perf_counter()
    for _ in range(iters):
        o = copy_obs(obs)
        model.formod(atm, o)
    dt = (time.perf_counter() - t0) / iters
    return o.rad, dt


def device_info():
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def run_default(args):
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from jurassic_tpu.forward import ForwardModel
    from jurassic_tpu.platform import enable_compile_cache
    from jurassic_tpu.utils.timer import profile_trace
    enable_compile_cache()
    dev = device_info()
    if dev["platform"] != "gpu" and not args.cpu:
        raise SystemExit(f"bench.py: no GPU ({dev}); pass --cpu to "
                         "measure the host backend")

    ctl, ft, atm, obs = build_workload(args.rays, args.channels,
                                       args.gases, args.nlos)
    ctl.raypack = args.raypack
    rads = {}
    for kernel in args.kernel.split(","):
        ctl.kernel = kernel
        model = ForwardModel(ctl, fast_tables=ft)
        # warm-up / compile, then the repeat-run consistency gate
        t0 = time.perf_counter()
        rad0, _ = time_formod(model, atm, obs, 1)
        warm = time.perf_counter() - t0
        rad1, _ = time_formod(model, atm, obs, 1)
        dev_rep = float(np.max(np.abs(rad0 - rad1)))
        if dev_rep != 0.0:
            raise SystemExit(f"bench.py: repeat runs of KERNEL = {kernel} "
                             f"deviate by {dev_rep:g}; timing refused")
        with profile_trace(args.trace):
            _, dt = time_formod(model, atm, obs, args.iters)
        rads[kernel] = rad0
        result = {
            "metric": "rays*channels/s",
            "value": obs.nr * ctl.nd / dt,
            "unit": "rays*channels/s",
            "kernel": kernel, "kernel_mode": model.kernel_mode,
            "rays": obs.nr, "channels": ctl.nd, "gases": ctl.ng,
            "nlos": ctl.nlos, "s_per_call": dt, "warmup_s": warm,
            "device": dev,
        }
        if len(rads) > 1:
            ref = next(iter(rads.values()))
            scale = float(np.abs(ref).max())
            result["max_rel_dev_vs_first_kernel"] = float(
                np.abs(rad0 - ref).max() / scale)
        print(json.dumps(result), flush=True)
        del model


def run_sweep(args):
    """nr x nd power-of-2 scaling sweep (formod.c:84-92), one JSON line
    per point."""
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from jurassic_tpu.forward import ForwardModel
    dev = device_info()
    for nd in (2, 8, 32, 128, 512, 1024):
        ctl, ft, atm, obs = build_workload(None, nd, args.gases, args.nlos)
        ctl.kernel = args.kernel
        model = ForwardModel(ctl, fast_tables=ft)
        for nr in (32, 128, 512, 1084):
            o = tile_obs(obs, nr)
            time_formod(model, atm, o, 1)    # warm-up/compile
            _, dt = time_formod(model, atm, o, max(2, args.iters // 4))
            print(json.dumps({"nr": nr, "nd": nd, "s_per_call": dt,
                              "rays_channels_per_s": nr * nd / dt,
                              "kernel_mode": model.kernel_mode,
                              "device": dev}), flush=True)
        del model, ft


def run_weak(args):
    """Sharding overhead on a virtual CPU mesh.

    Every mesh size is pinned to ONE fixed core (``taskset -c 0``):
    physical compute is then constant while the mesh and the workload
    grow together, so constant total throughput means no overhead and

        efficiency(n) = rays_per_s(n dev, n x rays) / rays_per_s(1 dev)

    measures what the sharded driver adds (partition bookkeeping,
    per-shard padding, result gather).  It says nothing about real
    interconnects."""
    results = []
    pin = ["taskset", "-c", "0"] if os.path.exists("/usr/bin/taskset") \
        else []
    reps = max(args.weak_reps, 5)
    for n in (1, 2, 4, 8):
        env = dict(
            os.environ, JAX_PLATFORMS="cpu",
            XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                       + f" --xla_force_host_platform_device_count={n}"
                       ).strip(),
            PYTHONPATH=str(REPO) + os.pathsep
            + os.environ.get("PYTHONPATH", ""))
        cmd = pin + [sys.executable, __file__, "--weak-child", str(n),
                     "--iters", str(args.iters),
                     "--weak-reps", str(reps),
                     "--channels", str(max(args.channels, 64)),
                     "--kernel", args.kernel]
        out = subprocess.run(cmd, env=env, capture_output=True, text=True)
        lines = out.stdout.strip().splitlines()
        if out.returncode != 0 or not lines:
            sys.stderr.write(out.stderr)
            raise RuntimeError(f"weak-child {n} failed "
                               f"(rc={out.returncode})")
        results.append(json.loads(lines[-1]))
    base = results[0]["rays_per_s_median"]
    worst_spread = 0.0
    for r in results:
        r["efficiency"] = r["rays_per_s_median"] / base
        worst_spread = max(worst_spread, r["rel_spread"])
        print(json.dumps(r))
    if worst_spread > 0.05:
        raise RuntimeError(
            f"weak-scaling spread {worst_spread:.1%} > 5%; refusing to "
            "report -- raise --weak-reps or quiesce the host")
    print(json.dumps({"metric": "cpu_mesh_sharding_efficiency_8dev",
                      "value": results[-1]["efficiency"],
                      "unit": "fraction",
                      "rel_spread_max": worst_spread}))


def run_weak_child(n_devices, args):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from jurassic_tpu.parallel import ShardedForwardModel, make_mesh
    # rays per device held constant (>= 512/device and >= 64 channels so
    # one repetition is far above timer noise)
    rays = 512 * n_devices
    ctl, ft, atm, obs = build_workload(rays, args.channels, 4, 160)
    ctl.kernel = args.kernel
    mesh = make_mesh(n_devices, 1)
    model = ShardedForwardModel(ctl, mesh, fast_tables=ft)
    time_formod(model, atm, obs, 1)              # warm-up/compile
    vals = []
    for _ in range(args.weak_reps):
        _, dt = time_formod(model, atm, obs, 1)
        vals.append(rays / dt)
    vals.sort()
    med = vals[len(vals) // 2]
    print(json.dumps({"n_devices": n_devices, "rays": rays,
                      "reps": args.weak_reps,
                      "rays_per_s_median": med,
                      "rays_per_s_min": vals[0],
                      "rays_per_s_max": vals[-1],
                      "rel_spread": (vals[-1] - vals[0]) / med}))


def run_multiproc(args):
    """1 process vs 2 processes on the CPU backend, same devices per
    process, fixed rays per device, through the jax.distributed plumbing
    (initialize, make_array_from_process_local_data, process_allgather).
    Each process is pinned to its own core (taskset), so

        efficiency = rays_per_s(2 proc) / (2 x rays_per_s(1 proc))

    bounds the process-boundary overhead of the multi-host path."""
    import socket

    def free_port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    dev_per_proc = 2
    rays_per_dev = 256
    reps = max(args.weak_reps, 5)
    have_taskset = os.path.exists("/usr/bin/taskset")
    results = []
    for nproc in (1, 2):
        port = free_port()
        rays = rays_per_dev * dev_per_proc * nproc
        env = dict(
            os.environ, JAX_PLATFORMS="cpu",
            XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                       + f" --xla_force_host_platform_device_count="
                         f"{dev_per_proc}").strip(),
            PYTHONPATH=str(REPO) + os.pathsep
            + os.environ.get("PYTHONPATH", ""))
        env.pop("JAX_COORDINATOR_ADDRESS", None)
        procs = []
        for pid in range(nproc):
            pin = (["taskset", "-c", str(pid)] if have_taskset else [])
            cmd = pin + [sys.executable, __file__,
                         "--multiproc-child", str(pid),
                         "--multiproc-nproc", str(nproc),
                         "--multiproc-port", str(port),
                         "--rays", str(rays),
                         "--channels", str(max(args.channels, 64)),
                         "--weak-reps", str(reps)]
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=1200)[0] for p in procs]
        rows = []
        for pid, (p, out) in enumerate(zip(procs, outs)):
            lines = [l for l in out.splitlines() if l.startswith("{")]
            if p.returncode != 0 or not lines:
                sys.stderr.write(out[-3000:])
                raise RuntimeError(f"multiproc child {pid} failed")
            rows.append(json.loads(lines[-1]))
        # the gather syncs every process; the SLOWEST process's wall
        # time is the batch time
        results.append({
            "n_processes": nproc, "devices_per_process": dev_per_proc,
            "rays": rays, "reps": reps,
            "rays_per_s_median": min(r["rays_per_s_median"] for r in rows),
            "rel_spread": max(r["rel_spread"] for r in rows)})
    base = results[0]["rays_per_s_median"]
    for r in results:
        r["efficiency"] = r["rays_per_s_median"] / (r["n_processes"] * base)
        print(json.dumps(r))
    print(json.dumps({"metric": "cpu_multiproc_efficiency_2proc",
                      "value": results[-1]["efficiency"],
                      "unit": "fraction",
                      "rel_spread_max": max(r["rel_spread"]
                                            for r in results)}))


def run_multiproc_child(args):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from jurassic_tpu.parallel import (ShardedForwardModel,
                                       init_distributed, make_mesh)
    init_distributed(f"localhost:{args.multiproc_port}",
                     num_processes=args.multiproc_nproc,
                     process_id=args.multiproc_child)
    devs = jax.devices()
    mesh = make_mesh(len(devs), 1, devices=devs)
    ctl, ft, atm, obs = build_workload(args.rays, args.channels, 4, 160)
    model = ShardedForwardModel(ctl, mesh, fast_tables=ft)
    time_formod(model, atm, obs, 1)              # warm-up/compile
    vals = []
    for _ in range(args.weak_reps):
        _, dt = time_formod(model, atm, obs, 1)
        vals.append(args.rays / dt)
    vals.sort()
    med = vals[len(vals) // 2]
    print(json.dumps({
        "pid": args.multiproc_child,
        "rays_per_s_median": med,
        "rel_spread": (vals[-1] - vals[0]) / med}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=None,
                    help="default: the 1084-ray reference baseline scan")
    ap.add_argument("--channels", type=int, default=100)
    ap.add_argument("--gases", type=int, default=4)
    ap.add_argument("--nlos", type=int, default=400)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--kernel", default="auto",
                    help="ctl KERNEL, or a comma list timed in turn "
                         "(auto|pallas|jax|exact)")
    ap.add_argument("--raypack", type=int, default=0,
                    help="rays per pipelined package (0 = auto)")
    ap.add_argument("--small", action="store_true",
                    help="tiny shapes for smoke runs")
    ap.add_argument("--cpu", action="store_true",
                    help="measure the host CPU backend")
    ap.add_argument("--trace", default=None,
                    help="jax.profiler trace logdir for the timed region")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--weak", action="store_true")
    ap.add_argument("--weak-reps", type=int, default=5,
                    help="repetitions per weak-scaling point (median "
                         "and spread are reported; spread > 5% fails)")
    ap.add_argument("--weak-child", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--multiproc", action="store_true",
                    help="timed 1-vs-2-process runs through "
                         "jax.distributed on the CPU backend")
    ap.add_argument("--multiproc-child", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--multiproc-nproc", type=int, default=1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--multiproc-port", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.small:
        args.rays, args.channels, args.nlos, args.iters = 64, 8, 48, 3

    if args.multiproc_child is not None:
        run_multiproc_child(args)
    elif args.multiproc:
        run_multiproc(args)
    elif args.weak_child is not None:
        run_weak_child(args.weak_child, args)
    elif args.weak:
        run_weak(args)
    elif args.sweep:
        run_sweep(args)
    else:
        run_default(args)


if __name__ == "__main__":
    main()
