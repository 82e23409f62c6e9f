"""Sharded forward-model runner.

The multi-device execution driver: the equivalent of the reference's
per-rank GPU dispatch + lane pipelining (GPUdrivers.cu:262-360).  Rays
are domain-decomposed over the mesh's ``"rays"`` axis (the reference's
embarrassingly parallel MPI/OpenMP ray batching, CPUdrivers.c:91-95);
spectral channels optionally shard over ``"chan"``.  Tables are placed
once per process (get_tbl_on_GPU, GPUdrivers.cu:83-90 ->
``jax.device_put`` with a channel-minor NamedSharding) and stay
resident; per-call observation data is placed with a rays-sharded
layout so the whole jitted pipeline -- ray tracing AND the RT
integration -- runs SPMD with no per-step collectives (the forward model
is collective-free by construction; the mesh exists for table broadcast
and result gather).

Kernel parity with the single-device driver: the fused kernel runs per
shard through ``jax.shard_map`` (the analogue of the reference launching
its fusion kernel on every device, ``cudaSetDevice(MPIlocalrank)`` +
``formod_one_package``, GPUdrivers.cu:262-360); a channel shard is a
plain slice of the channel-minor tables.  The jnp scan pipeline
partitions automatically under GSPMD and needs no explicit mapping.
"""
from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import Ctl
from ..forward import ForwardModel, RtOut, rt_fused_core
from ..geometry import (LosData, RayProfiles, build_ray_profiles,
                        hydrostatic_atm, trace_rays)
from ..io_tab import Atm, Obs
from ..ops.rt_fused import KernelAxes
from ..tables import EgaTables
from .mesh import (CHAN_AXIS, RAY_AXIS, chan_minor_sharding,
                   ray_sharding, replicated)


def _place_tables(mesh: Mesh, model: ForwardModel) -> None:
    """Shard the device-resident table pytree channel-minor and the
    per-channel vectors over ``"chan"``; scalars/axes replicate."""
    put = jax.device_put
    model.dev_tbl = type(model.dev_tbl)(*(
        put(leaf, chan_minor_sharding(mesh, np.ndim(leaf)))
        for leaf in model.dev_tbl))
    model.sr = put(model.sr, chan_minor_sharding(mesh, 2))
    model.st = put(model.st, replicated(mesh))
    model.nu = put(model.nu, chan_minor_sharding(mesh, 1))
    model.window = put(model.window, chan_minor_sharding(mesh, 1))
    model.cc = type(model.cc)(*(
        put(leaf, chan_minor_sharding(mesh, 1)) for leaf in model.cc))
    if model.kernel_mode == "pallas":
        model.kernel_axes = KernelAxes(*(
            put(leaf, replicated(mesh)) for leaf in model.kernel_axes))
        model.cc_rows = put(model.cc_rows, chan_minor_sharding(mesh, 2))


def make_sharded_kernel_fn(mesh: Mesh, model: ForwardModel):
    """jit(shard_map(...)) of the fused-kernel RT step over the
    ("rays", "chan") mesh: every shard runs the same kernel the
    single-device driver runs (rt_fused_core) on its ray block and its
    slice of the channel-minor tables."""
    chan = lambda nd: P(*([None] * (nd - 1) + [CHAN_AXIS]))
    tbl_specs = type(model.dev_tbl)(*(chan(np.ndim(leaf))
                                      for leaf in model.dev_tbl))
    ax_specs = KernelAxes(*(P() for _ in model.kernel_axes))
    r1, r2, r3 = P(RAY_AXIS), P(RAY_AXIS, None), P(RAY_AXIS, None, None)
    los_specs = LosData(
        z=r2, lon=r2, lat=r2, p=r2, t=r2, q=r3, k=r3, ds=r2, u=r3,
        valid=r2, np_=r1, tsurf=r1, tpz=r1, tplon=r1, tplat=r1)
    in_specs = (tbl_specs, ax_specs, chan(2), chan(2), P(), chan(1),
                los_specs, r1)
    body = partial(rt_fused_core, flags=model.flags, ig_co2=model.ig_co2,
                   ig_h2o=model.ig_h2o, bbt=bool(model.ctl.write_bbt),
                   interpret=model.interpret)
    out_specs = RtOut(rad=P(RAY_AXIS, CHAN_AXIS),
                      tau=P(RAY_AXIS, CHAN_AXIS))
    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def global_put(x, sharding):
    """Place a full host copy of the data with a sharding, multi-host
    aware.

    Single-process: plain ``device_put``.  Multi-process (after
    mesh.init_distributed): every process holds the same full host array
    (the drop-in formod contract) and contributes only the shards its
    local devices own (``jax.make_array_from_callback`` materialises
    per-shard slices, so no device ever sees the full batch)."""
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, sharding,
                                        lambda idx: x[idx])


def global_put_local(x_local, global_shape, sharding):
    """Place PER-PROCESS data: each process passes only its own slice of
    the ray axis and the pieces assemble into one global array without
    any host holding the full batch
    (``jax.make_array_from_process_local_data`` — the per-host input
    loading of SURVEY section 5's distributed-backend design; the
    upstream MPI harness partitions the obs batch externally the same
    way)."""
    if jax.process_count() == 1:
        return jax.device_put(np.asarray(x_local), sharding)
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(x_local), global_shape)


def host_gather(x) -> np.ndarray:
    """Distributed device array -> full host array on EVERY process
    (the result-gather of SURVEY section 5's distributed backend; the
    forward model itself stays collective-free)."""
    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


class ShardedForwardModel(ForwardModel):
    """Forward model executing SPMD over a ("rays", "chan") mesh.

    Drop-in for :class:`ForwardModel`; single-device behaviour is the
    degenerate 1x1 mesh.  Channel sharding requires ``nd`` divisible by
    the mesh's chan extent (channels are never padded because the
    channel set is part of the physics configuration).  formod
    (including the RAYPACK package pipelining) is inherited: the ray
    axis pads to the mesh multiple via ``ray_multiple``.
    """

    def __init__(self, ctl: Ctl, mesh: Mesh, tables: EgaTables | None = None,
                 directory: str = ".", dtype=None, fast_tables=None,
                 interpret: bool = False):
        n_chan = mesh.shape[CHAN_AXIS]
        if ctl.nd % n_chan != 0:
            raise ValueError(
                f"ND={ctl.nd} not divisible by chan mesh axis {n_chan}")
        super().__init__(ctl, tables, directory, dtype,
                         fast_tables=fast_tables, interpret=interpret)
        if self.exec_device is not None:
            raise ValueError(
                "USEGPU = 0 (never) contradicts running on an "
                "accelerator mesh; drop the mesh or set USEGPU = -1/1")
        self.mesh = mesh
        self.n_ray_shards = mesh.shape[RAY_AXIS]
        self.ray_multiple = self.n_ray_shards
        _place_tables(mesh, self)
        self._kernel_fn = (make_sharded_kernel_fn(mesh, self)
                           if self.kernel_mode == "pallas" else None)

    def trace(self, atm: Atm, obs: Obs, hydro: bool = True) -> LosData:
        """Rays-sharded tracing: profiles and observer geometry are placed
        with ``P("rays", ...)`` so the jitted tracer (a vmap over rays)
        partitions over the mesh; output shardings propagate."""
        if hydro:
            hydrostatic_atm(self.ctl, atm)
        prof = build_ray_profiles(self.ctl, atm, obs, self.dtype)
        prof = RayProfiles(*(
            global_put(leaf, ray_sharding(self.mesh, np.ndim(leaf)))
            for leaf in prof))
        sh1 = ray_sharding(self.mesh, 1)
        obs_geo = {
            name: global_put(
                np.asarray(getattr(obs, name), self.dtype), sh1)
            for name in ("obsz", "obslon", "obslat", "vpz", "vplon", "vplat")}
        return trace_rays(self.ctl, prof, obs_geo, self.dtype)

    def integrate(self, los: LosData) -> RtOut:
        if self.kernel_mode == "pallas":
            return self._kernel_fn(self.dev_tbl, self.kernel_axes,
                                   self.cc_rows, self.sr, self.st, self.nu,
                                   los, los.tsurf)
        return super().integrate(los)

    def _outputs_to_host_many(self, items):
        """Distributed arrays need the per-leaf allgather path (a plain
        device_get cannot materialise non-addressable shards)."""
        return [tuple(host_gather(a).astype(np.float64)[:r] for a in arrays)
                for arrays, r in items]
