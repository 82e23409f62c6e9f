"""The forward model: formod pipeline.

A JAX re-expression of the reference execution drivers
(``formod``/``formod_CPU``, CPUdrivers.c:109-193, and ``formod_GPU``,
GPUdrivers.cu:187-360): one jitted radiative-transfer pipeline that XLA
compiles for the local backend.  The reference's structural tricks map as:

* the 16-way kernel multiversioning over the 4-bit continuum mask
  (jr_multiversion4gases.h) -> 4 static booleans burned into the jit trace;
* the fused GPU kernel (jr_fusion_kernel.mv4g.cu) -> on the GPU, the fused
  Pallas kernel of :mod:`jurassic_tpu.ops.rt_fused`; elsewhere, and as the
  reference path, one ``lax.scan`` over the LOS axis whose body is batched
  over [rays, channels];
* the sequential transmittance recursion (``tau_path`` loop-carried state,
  CPUdrivers.c:66-83 "non-parallelisable") -> the loop carry ``[R, G, D]``;
* the observation mask (save_mask/apply_mask, jr_common.h:193-210) ->
  host-side NaN bookkeeping around the jitted call.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import Ctl
from .constants import C1, C2, TAU_CUTOFF
from .geometry import (LosData, build_ray_profiles, hydrostatic_atm,
                       trace_rays)
from .io_tab import Atm, Obs, read_shape
from .ops.continua import ContinuaCoeffs, beta_ds, precompute_continua
from .ops.ega import (EgaDeviceTables, FastDeviceTables, ega_eps_exact,
                      ega_eps_fast)
from .ops.rt_fused import (N_AX, N_IDX, N_SEG, kernel_axes, pack_continua,
                           rt_fused)
from .platform import select_platform
from .tables import (EgaTables, FastTables, build_fast_tables,
                     load_tables_cached)


# ---------------------------------------------------------------------------
# Device-side table containers

def ega_tables_to_device(tbl: EgaTables) -> EgaDeviceTables:
    """Upload padded tables; payloads stay f32 (real_tblND_t, jurassic.h:387),
    axes in f64 like the reference."""
    return EgaDeviceTables(
        np_=jnp.asarray(tbl.np_), nt=jnp.asarray(tbl.nt),
        nu=jnp.asarray(tbl.nu), p=jnp.asarray(tbl.p), t=jnp.asarray(tbl.t),
        u=jnp.asarray(tbl.u), eps=jnp.asarray(tbl.eps))


def fast_tables_to_device(tbl: FastTables) -> FastDeviceTables:
    return FastDeviceTables(
        np_=jnp.asarray(tbl.np_), nt=jnp.asarray(tbl.nt),
        p=jnp.asarray(tbl.p), t=jnp.asarray(tbl.t), nu=jnp.asarray(tbl.nu),
        log2_u0=jnp.asarray(tbl.log2_u0), eps=jnp.asarray(tbl.eps),
        valid=jnp.asarray(tbl.valid))


def continua_to_device(cc: ContinuaCoeffs, dtype) -> ContinuaCoeffs:
    return ContinuaCoeffs(*(jnp.asarray(np.asarray(f), dtype) for f in cc))


# ---------------------------------------------------------------------------
# Source function and brightness temperature

def src_planck(sr, st, t):
    """Table-interpolated source radiance [D] at temperature t
    (src_planck_core, jr_common.h:221-224; locate_st index (int)(4 t)-400,
    jr_common.h:83-84, clamped here for safety)."""
    n = st.shape[0]
    it = jnp.clip((4.0 * t).astype(jnp.int32) - 400, 0, n - 2)
    t0, t1 = st[it], st[it + 1]
    return sr[it] + (t - t0) * (sr[it + 1] - sr[it]) / (t1 - t0)


def brightness_jnp(rad, nu):
    """Radiance -> brightness temperature (brightness_core,
    jr_common.h:189-190)."""
    return C2 * nu / jnp.log1p(C1 * nu ** 3 / rad)


# ---------------------------------------------------------------------------
# The jitted RT integration

class RtOut(NamedTuple):
    rad: jax.Array  # [R, D]
    tau: jax.Array  # [R, D]


@partial(jax.jit,
         static_argnames=("flags", "ig_co2", "ig_h2o", "use_fast", "bbt"))
def rt_integrate(tbl, sr, st, nu, cc: ContinuaCoeffs, window, los: LosData,
                 tsurf, flags, ig_co2, ig_h2o, use_fast, bbt) -> RtOut:
    """Radiative-transfer integration over traced lines of sight.

    The analogue of the fused GPU kernel + surface + BT kernels
    (GPUdrivers.cu:226-240): a single ``lax.scan`` over the LOS step axis,
    body batched over [R] rays x [D] channels, carrying
    (rad [R,D], tau [R,D], tau_path [R,G,D]).

    Args:
      tbl: EgaDeviceTables or FastDeviceTables (selected by use_fast).
      sr, st: source-function table [S, D] / axis [S].
      nu: channel wavenumbers [D] (for BBT conversion).
      cc: per-channel continuum coefficients.
      window: [D] int32 channel->window map.
      los: traced rays (LosData, [R, NLOS, ...]).
      tsurf: [R] surface temperature (-999 => no surface hit).
      flags: static (co2, h2o, n2, o2) continuum switches incl. emitter
        presence (fourbit, CPUdrivers.c:130-134).
      ig_co2, ig_h2o: static emitter indices (>= 0 when the matching flag
        is set).
      use_fast: static kernel selector.
      bbt: static WRITE_BBT switch (radiance_to_brightness_CPU,
        CPUdrivers.c:6-14).
    """
    dtype = los.p.dtype
    R, NLOS = los.ds.shape
    G = los.u.shape[2]
    D = sr.shape[1]
    ega = ega_eps_fast if use_fast else ega_eps_exact

    sr_ = sr.astype(dtype)
    st_ = st.astype(dtype)

    def step(carry, inp):
        rad, tau, tau_path = carry
        p, t, q, k, ds, u, valid = inp
        # extinction + continua (continua_core, jr_common.h:397-409)
        kw = jnp.take(k, window, axis=1)                       # [R, D]
        zq = jnp.zeros((R,), dtype)
        q_h2o = q[:, ig_h2o] if ig_h2o >= 0 else zq
        u_h2o = u[:, ig_h2o] if ig_h2o >= 0 else zq
        u_co2 = u[:, ig_co2] if ig_co2 >= 0 else zq
        bds = beta_ds(flags, cc, kw, ds[:, None], p[:, None], t[:, None],
                      q_h2o[:, None], u_co2[:, None], u_h2o[:, None])
        # EGA transmittance update (apply_ega_core, jr_common.h:271-280)
        factor = jax.vmap(
            lambda tp, tt, uu, pp: ega(tbl, tp, tt, uu, pp)
        )(tau_path, t, u, p)                                   # [R, G, D]
        tau_gas = jnp.prod(factor, axis=1)                     # [R, D]
        tau_path = jnp.where(valid[:, None, None],
                             tau_path * factor, tau_path)
        # source term (src_planck_core) + integration (new_obs_core,
        # jr_common.h:294-300)
        src = jax.vmap(lambda tt: src_planck(sr_, st_, tt))(t)  # [R, D]
        eps = 1.0 - tau_gas * jnp.exp(-bds)
        upd = valid[:, None] & (tau_gas > TAU_CUTOFF)
        rad = jnp.where(upd, rad + src * eps * tau, rad)
        tau = jnp.where(upd, tau * (1.0 - eps), tau)
        return (rad, tau, tau_path), None

    init = (jnp.zeros((R, D), dtype), jnp.ones((R, D), dtype),
            jnp.ones((R, G, D), dtype))
    xs = (jnp.moveaxis(los.p, 1, 0), jnp.moveaxis(los.t, 1, 0),
          jnp.moveaxis(los.q, 1, 0), jnp.moveaxis(los.k, 1, 0),
          jnp.moveaxis(los.ds, 1, 0), jnp.moveaxis(los.u, 1, 0),
          jnp.moveaxis(los.valid, 1, 0))
    (rad, tau, _), _ = jax.lax.scan(step, init, xs)

    # surface emission (add_surface_core, jr_common.h:228-234)
    src_surf = jax.vmap(lambda tt: src_planck(sr_, st_, tt))(tsurf)
    rad = jnp.where((tsurf > 0.0)[:, None], rad + src_surf * tau, rad)

    if bbt:
        rad = brightness_jnp(rad, nu.astype(dtype))
    return RtOut(rad=rad, tau=tau)


def rt_fused_core(tbl, ax, cc_rows, sr, st, nu, los: LosData, tsurf,
                  flags, ig_co2, ig_h2o, bbt, interpret=False) -> RtOut:
    """Unjitted fused-kernel RT step: the kernel plus the surface
    emission (add_surface_core, jr_common.h:228-234) and brightness
    epilogues, which stay outside the kernel as cheap [R, D] jnp ops like
    the reference's separate surface/BT kernels (GPUdrivers.cu:234-240).
    Also the per-shard body of the multi-device driver
    (parallel/sharded.py)."""
    rad, tau = rt_fused(tbl, ax, cc_rows, sr, st, los, flags=flags,
                        ig_co2=ig_co2, ig_h2o=ig_h2o, interpret=interpret)
    f32 = jnp.float32
    sr_, st_, ts = sr.astype(f32), st.astype(f32), tsurf.astype(f32)
    src_surf = jax.vmap(lambda tt: src_planck(sr_, st_, tt))(ts)
    rad = jnp.where((ts > 0.0)[:, None], rad + src_surf * tau, rad)
    if bbt:
        rad = brightness_jnp(rad, nu.astype(f32))
    return RtOut(rad=rad, tau=tau)


@partial(jax.jit, static_argnames=("flags", "ig_co2", "ig_h2o", "bbt",
                                   "interpret"))
def rt_integrate_fused(tbl, ax, cc_rows, sr, st, nu, los: LosData, tsurf,
                       flags, ig_co2, ig_h2o, bbt, interpret=False) -> RtOut:
    """RT integration through the fused kernel (ops/rt_fused.py): same
    contract as :func:`rt_integrate`, float32 outputs."""
    return rt_fused_core(tbl, ax, cc_rows, sr, st, nu, los, tsurf, flags,
                         ig_co2, ig_h2o, bbt, interpret)


def resolve_kernel(kernel: str, platform: str, interpret: bool) -> str:
    """KERNEL -> the path that runs: "pallas" (the fused kernel), "jax"
    (the jnp scan on log-uniform fast tables) or "exact" (the jnp scan
    on the reference tables).  ``auto`` takes the kernel on the GPU and
    the jnp scan elsewhere; an explicit ``pallas`` off the GPU needs the
    caller's explicit request for interpret mode."""
    if kernel in ("jax", "fast"):
        return "jax"
    if kernel == "exact":
        return "exact"
    if kernel == "auto":
        return "pallas" if platform == "gpu" else "jax"
    if kernel == "pallas":
        if platform != "gpu" and not interpret:
            raise ValueError(
                "KERNEL = pallas compiles for a GPU backend only, and this "
                f"run's platform is '{platform}'; use KERNEL = jax, or "
                "ForwardModel(..., interpret=True) to run the kernel in "
                "Pallas interpret mode")
        return "pallas"
    if kernel == "turbo":
        raise ValueError(
            "KERNEL = turbo (Chebyshev-compressed tables) was removed; "
            "use KERNEL = pallas or KERNEL = jax")
    raise ValueError(f"unknown KERNEL = {kernel} "
                     "(auto | pallas | jax | fast | exact)")


# ---------------------------------------------------------------------------
# FOV convolution (formod_fov, jurassic.c:214-258)

def formod_fov(ctl: Ctl, obs: Obs) -> None:
    """Convolve rad/tau profiles with the instrument field of view
    (formod_fov, jurassic.c:214-258).

    Fully vectorized host-side NumPy (the round-3 per-ray Python loop
    became the host bottleneck at 10k+-ray batches): every ray's
    same-time neighbour window (at most 2 NFOV + 1 candidates) is
    compacted with a stable sort, the shape-grid interpolation indices
    come from a batched counted comparison (== searchsorted per row),
    and the weight sum is one einsum.  Ray-chunked so the [chunk,
    NSHAPE, D] intermediates stay bounded."""
    if ctl.fov == "-":
        return
    from .config import NFOV
    dz, w = read_shape(ctl.fov)
    R = obs.nr
    rad0, tau0 = obs.rad.copy(), obs.tau.copy()
    WW = 2 * NFOV + 1
    ir = np.arange(R)
    col = np.clip(ir[:, None] + np.arange(-NFOV, NFOV + 1), 0, R - 1)
    mask = (obs.time[col] == obs.time[:, None]) \
        & (ir[:, None] + np.arange(-NFOV, NFOV + 1) >= 0) \
        & (ir[:, None] + np.arange(-NFOV, NFOV + 1) < R)
    n = mask.sum(axis=1)
    if (n < 2).any():
        raise ValueError("Cannot apply FOV convolution!")
    # compact the selected neighbours to the front, original order kept
    ordr = np.argsort(~mask, axis=1, kind="stable")
    colc = np.take_along_axis(col, ordr, axis=1)          # [R, WW]
    inb = np.arange(WW)[None, :] < n[:, None]
    zwin = np.where(inb, obs.vpz[colc], np.inf)
    wsum = np.sum(w)
    chunk = max(1, (64 << 20) // max(dz.size * obs.rad.shape[1] * 8, 1))
    for c0 in range(0, R, chunk):
        sl = slice(c0, min(c0 + chunk, R))
        zfov = obs.vpz[sl, None] + dz[None, :]            # [r, NS]
        # locate() on each compacted ray-altitude grid
        cnt = np.sum(zwin[sl][:, None, :] <= zfov[:, :, None], axis=2)
        idx = np.clip(cnt - 1, 0, (n[sl] - 2)[:, None])
        g0 = np.take_along_axis(colc[sl], idx, axis=1)    # [r, NS]
        g1 = np.take_along_axis(colc[sl], idx + 1, axis=1)
        z0, z1 = obs.vpz[g0], obs.vpz[g1]
        f = ((zfov - z0) / (z1 - z0))[:, :, None]
        for src, dst in ((rad0, obs.rad), (tau0, obs.tau)):
            v0, v1 = src[g0], src[g1]                     # [r, NS, D]
            dst[sl] = np.einsum("s,rsd->rd", w,
                                v0 + f * (v1 - v0)) / wsum


# ---------------------------------------------------------------------------
# Host orchestration

def pad_obs(obs: Obs, r_pad: int) -> Obs:
    """Pad the ray axis to r_pad by repeating the last ray (cheap,
    discarded after the gather; keeps every shard's geometry well-posed
    so the tracer never sees degenerate inputs)."""
    import dataclasses
    r = obs.nr
    if r == r_pad:
        return obs
    fields = {}
    for f in dataclasses.fields(Obs):
        arr = np.asarray(getattr(obs, f.name))
        reps = (r_pad - r,) + (1,) * (arr.ndim - 1)
        fields[f.name] = np.concatenate([arr, np.tile(arr[-1:], reps)])
    return Obs(**fields)


class ForwardModel:
    """Loaded, device-resident forward model for one ctl configuration.

    The analogue of the reference's once-per-process state: the cached
    table upload (get_tbl, jr_common.h:61-79 / get_tbl_on_GPU,
    GPUdrivers.cu:83-90) plus the continuum setup (CPUdrivers.c:126-134).
    Construct once, call :meth:`formod` per observation batch.

    ``interpret`` runs the fused kernel in Pallas interpret mode; it is
    the only way to run ``KERNEL = pallas`` off the GPU (the CPU tests).
    """

    def __init__(self, ctl: Ctl, tables: EgaTables | None = None,
                 directory: str = ".", dtype=None,
                 fast_tables: FastTables | None = None,
                 interpret: bool = False):
        self.ctl = ctl
        self.ray_multiple = 1   # mesh ray-shard count (ShardedForwardModel)
        if ctl.formod != 2:
            # The reference ships only the EGA forward model and hard-asserts
            # on the CGA selector when not compiled in (jr_common.h:701-707);
            # RFM is declared but not implemented there either.
            raise ValueError(
                f"FORMOD = {ctl.formod} is not supported (1 = CGA and "
                "3 = RFM are not implemented; use FORMOD = 2 for EGA)")
        self.platform, self.exec_device = select_platform(ctl.usegpu)
        self.kernel_mode = resolve_kernel(ctl.kernel, self.platform,
                                          interpret)
        self.interpret = bool(interpret)
        self._raypack_cache: dict = {}
        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self.dtype = dtype
        if tables is None and fast_tables is None:
            tables = load_tables_cached(ctl, directory)
        self.tables = tables
        with self._exec_ctx():       # tables live where formod runs
            self._upload(ctl, tables, fast_tables, dtype)

    def _upload(self, ctl, tables, fast_tables, dtype):
        self.use_fast = self.kernel_mode != "exact"
        self.kernel_axes = None
        if self.use_fast:
            if fast_tables is None:
                fast_tables = build_fast_tables(tables)
            self.dev_tbl = fast_tables_to_device(fast_tables)
            if self.kernel_mode == "pallas":
                self.kernel_axes = kernel_axes(fast_tables)
                if self.kernel_axes is None:
                    if ctl.kernel == "pallas":
                        raise ValueError(
                            "KERNEL = pallas requires channel-uniform table "
                            "axes per gas; use KERNEL = jax for tables "
                            "whose (p, T) grids differ between channels")
                    self.kernel_mode = "jax"
        else:
            self.dev_tbl = ega_tables_to_device(tables)
        src = tables if tables is not None else fast_tables
        self.sr = jnp.asarray(src.sr)
        self.st = jnp.asarray(src.st)
        self.nu = jnp.asarray(ctl.nu)
        self.window = jnp.asarray(ctl.window, jnp.int32)
        self.cc = continua_to_device(precompute_continua(ctl), dtype)
        if self.kernel_mode == "pallas":
            self.cc_rows = pack_continua(precompute_continua(ctl),
                                         np.asarray(ctl.window), ctl.nd,
                                         ctl.nw)
        # continuum configuration (fourbit, CPUdrivers.c:126-134)
        self.ig_co2 = ctl.emitter_index("CO2")
        self.ig_h2o = ctl.emitter_index("H2O")
        self.flags = (
            ctl.ctm_co2 == 1 and self.ig_co2 >= 0,
            ctl.ctm_h2o == 1 and self.ig_h2o >= 0,
            ctl.ctm_n2 == 1,
            ctl.ctm_o2 == 1,
        )

    def per_ray_device_bytes(self) -> int:
        """Modelled device bytes per ray of one in-flight package: the
        traced LosData, the rad/tau outputs and the transients of the path
        that runs -- the fused kernel's segment streams and bracketing
        values, or the jnp scan's step-major input copies and one step's
        table rows.  (Tables are process-resident and excluded, like the
        reference's lane sizing, GPUdrivers.cu:278,296-307.)  For the
        kernel at the flagship this is 158 kB/ray; an H100 measured
        154 kB/ray (peak_bytes_in_use less the bytes still in use after
        a 10,840-ray call)."""
        ctl = self.ctl
        S, G, W, D = ctl.nlos, ctl.ng, ctl.nw, max(ctl.nd, 1)
        b = np.dtype(self.dtype).itemsize
        los = S * (8 + 2 * G + W) * b
        out = 2 * D * b + (G + 2) * D * b         # rad, tau, carry
        if self.kernel_mode == "pallas":
            streams = S * ((N_SEG + W + G + N_AX * G) * 4 + N_IDX * G * 4)
            work = streams + S * G * N_AX * b
        elif self.kernel_mode == "jax":
            work = S * (5 + 2 * G + W) * b + 16 * G * 4 * D * b
        else:
            U = int(self.dev_tbl.u.shape[3])
            work = S * (5 + 2 * G + W) * b + 8 * G * U * D * b
        return los + out + work

    def package_size(self, nr: int, pack: int | None = None) -> int:
        """The ACTUAL per-package ray count formod runs for an nr-ray
        batch: the batch is split into equal-size packages (same count
        as the resolved RAYPACK size implies, never larger, rounded up
        to the mesh ray-shard multiple).  Sizing 1084 rays as 2x717
        would trace 350 dead padded rays (+32% device work); 2x542
        pads only to the shard multiple.  0 = monolithic."""
        if pack is None:
            pack = self._resolve_raypack(nr)
        if not (0 < pack < nr):
            return 0
        m = max(self.ray_multiple, 1)
        npk = -(-nr // pack)
        even = -(-nr // npk)
        return -(-even // m) * m

    def _resolve_raypack(self, nr: int) -> int:
        """RAYPACK = 0 (default): auto-size the package so ~2 in-flight
        packages fit 90% of free device memory (the reference sizes its
        GPU lane pool to 90% of free, GPUdrivers.cu:296-321); > 0: the
        explicit knob; < 0: force one monolithic batch.  Runs on the host
        CPU use one batch; an accelerator must report ``memory_stats``."""
        pack = int(self.ctl.raypack)
        if pack > 0:
            return pack
        if pack < 0:
            return 0
        dev = (self.exec_device if self.exec_device is not None
               else jax.local_devices()[0])
        if dev.platform == "cpu":
            return 0
        cache = self._raypack_cache
        if nr in cache:
            return cache[nr]
        st = dev.memory_stats()
        if not st or "bytes_limit" not in st:
            raise RuntimeError(
                f"RAYPACK auto-sizing needs memory_stats() from {dev}, "
                "which reports none; set RAYPACK explicitly")
        free = int(st["bytes_limit"]) - int(st.get("bytes_in_use", 0))
        prb = self.per_ray_device_bytes()
        # ~2 packages in flight (the package loop overlaps package n+1's
        # dispatch with package n's compute); a package's rays split
        # across the mesh's ray shards, so the per-DEVICE budget sizes
        # ray_multiple times as many package rays
        budget = int(0.9 * free) // 2
        fit = max(budget // max(prb, 1), 1) * max(self.ray_multiple, 1)
        if fit >= nr:
            fit = 0
        else:
            print(f"# RAYPACK auto: {fit} rays/package "
                  f"({prb} B/ray, {free / 1e9:.2f} GB free)")
        # fixed per batch size, so repeated calls reuse one package shape
        cache[nr] = fit
        return fit

    def _exec_ctx(self):
        """USEGPU = 0: pin the whole pipeline to the host CPU backend
        (jit follows the committed default device); no-op otherwise."""
        import contextlib
        return (jax.default_device(self.exec_device)
                if self.exec_device is not None
                else contextlib.nullcontext())

    def integrate(self, los: LosData) -> RtOut:
        """RT integration with the resolved kernel: the fused kernel
        (jr_fusion_kernel.mv4g.cu analogue) or the jnp scan pipeline."""
        if self.kernel_mode == "pallas":
            return rt_integrate_fused(
                self.dev_tbl, self.kernel_axes, self.cc_rows, self.sr,
                self.st, self.nu, los, los.tsurf, self.flags, self.ig_co2,
                self.ig_h2o, bool(self.ctl.write_bbt), self.interpret)
        return rt_integrate(
            self.dev_tbl, self.sr, self.st, self.nu, self.cc, self.window,
            los, los.tsurf, self.flags, self.ig_co2, self.ig_h2o,
            self.use_fast, bool(self.ctl.write_bbt))


    def trace(self, atm: Atm, obs: Obs, hydro: bool = True) -> LosData:
        """Hydrostatic adjustment + ray tracing (hydrostatic1d_CPU +
        raytrace_rays_CPU, CPUdrivers.c:89-103).  Mutates atm.p like the
        reference."""
        if hydro:
            hydrostatic_atm(self.ctl, atm)
        prof = build_ray_profiles(self.ctl, atm, obs, self.dtype)
        obs_geo = dict(
            obsz=jnp.asarray(obs.obsz, self.dtype),
            obslon=jnp.asarray(obs.obslon, self.dtype),
            obslat=jnp.asarray(obs.obslat, self.dtype),
            vpz=jnp.asarray(obs.vpz, self.dtype),
            vplon=jnp.asarray(obs.vplon, self.dtype),
            vplat=jnp.asarray(obs.vplat, self.dtype))
        return trace_rays(self.ctl, prof, obs_geo, self.dtype)

    def pencil_trace(self, atm: Atm, obs: Obs) -> LosData:
        """Host "pencil" tracing for IP=2/3 (intpol_atm_2d/3d,
        jurassic.c:704-804): straight-ray geometry over the global
        altitude range, then the atmosphere re-sampled at every LOS
        point with the 2D/3D interpolator.

        The reference's own execution drivers reject IP != 1 outright
        (the device interpolator asserts ip == 1, jr_common.h:573,581);
        this path extends formod to the track/Lagrangian modes the
        reference reserves for its retrieval library.  REFRAC must be
        off: ray bending would need in-path (p, T) during tracing.
        """
        ctl = self.ctl
        if ctl.refrac:
            raise NotImplementedError(
                "IP=2/3 requires REFRAC=0 (straight rays); the reference "
                "formod does not support IP != 1 at all (jr_common.h:573)")
        from .interp_atm import intpol_atm_geo, split_profiles
        hydrostatic_atm(ctl, atm)
        # geometry-only tracing: 1D dummy profiles spanning the global
        # altitude range (values are re-sampled afterwards)
        import dataclasses
        first = dataclasses.replace(atm)
        zs = np.sort(np.unique(atm.z))
        n0 = zs.size
        first.time = np.full(n0, atm.time[0])
        first.z = zs
        first.lon = np.zeros(n0)
        first.lat = np.zeros(n0)
        first.p = np.interp(zs, atm.z[np.argsort(atm.z)],
                            atm.p[np.argsort(atm.z)])
        first.t = np.full(n0, 250.0)
        first.q = np.zeros((ctl.ng, n0))
        first.k = np.zeros((ctl.nw, n0))
        geo_ctl = dataclasses.replace(ctl, ip=1)
        prof = build_ray_profiles(geo_ctl, first, obs, self.dtype)
        obs_geo = dict(
            obsz=jnp.asarray(obs.obsz, self.dtype),
            obslon=jnp.asarray(obs.obslon, self.dtype),
            obslat=jnp.asarray(obs.obslat, self.dtype),
            vpz=jnp.asarray(obs.vpz, self.dtype),
            vplon=jnp.asarray(obs.vplon, self.dtype),
            vplat=jnp.asarray(obs.vplat, self.dtype))
        los = trace_rays(geo_ctl, prof, obs_geo, self.dtype)
        # re-sample the atmosphere along the traced paths; padded LOS
        # points (beyond np_) carry garbage coordinates, so clamp them to
        # the first atmosphere point before interpolating and zero their
        # contributions afterwards
        valid = np.asarray(los.valid, bool)
        z = np.where(valid, np.asarray(los.z, np.float64), atm.z[0])
        lon = np.where(valid, np.asarray(los.lon, np.float64), atm.lon[0])
        lat = np.where(valid, np.asarray(los.lat, np.float64), atm.lat[0])
        tp = split_profiles(atm) if ctl.ip == 2 else None
        p, t, q, k = intpol_atm_geo(ctl, atm, z.ravel(), lon.ravel(),
                                    lat.ravel(), tp)
        R, S = z.shape
        # IP=3 returns NaN outside every influence radius
        # (jurassic.c:800-803); for the pencil forward those segments
        # carry no data -> treat as vacuum rather than poisoning the ray
        nodata = ~np.isfinite(t.reshape(R, S))
        keep = valid & ~nodata
        p = np.where(keep, p.reshape(R, S), 1e-3)
        t = np.where(keep, t.reshape(R, S), 250.0)
        v3 = keep[:, :, None]
        q = np.where(v3, np.moveaxis(q.reshape(ctl.ng, R, S), 0, -1), 0.0)
        k = np.where(v3, np.moveaxis(k.reshape(ctl.nw, R, S), 0, -1), 0.0)
        ds = np.where(valid, np.asarray(los.ds, np.float64), 0.0)
        from .constants import KB
        u = (10.0 / KB) * q * p[:, :, None] / t[:, :, None] * ds[:, :, None]
        # surface temperature from the re-sampled boundary point
        np_ = np.asarray(los.np_)
        tsurf = np.asarray(los.tsurf, np.float64)
        hit = tsurf > -998.0
        last = np.clip(np_ - 1, 0, S - 1)
        tsurf = np.where(hit, t[np.arange(R), last], tsurf)
        d = self.dtype
        return los._replace(
            p=jnp.asarray(p, d), t=jnp.asarray(t, d), q=jnp.asarray(q, d),
            k=jnp.asarray(k, d), u=jnp.asarray(u, d),
            tsurf=jnp.asarray(tsurf, d))

    def formod(self, atm: Atm, obs: Obs) -> Obs:
        """Full forward model (formod, CPUdrivers.c:179-193).

        Fills obs.rad/obs.tau/tangent points in place and returns obs.

        With ``RAYPACK > 0`` the scan is processed in fixed-size ray
        packages: JAX's async dispatch overlaps host-side profile prep
        of package k+1 with the device raytrace + RT integration of
        package k — the stream/package overlap of the reference GPU
        driver (GPUdrivers.cu:176-183, 296-335) without explicit
        streams.  Results transfer back only after every package has
        been enqueued."""
        ctl = self.ctl
        if ctl.checkmode:
            print(f"# formod: checkmode = {ctl.checkmode}, "
                  "no actual computation is performed!")
            return obs
        mask = ~np.isfinite(obs.rad)                  # save_mask
        pack = self._resolve_raypack(obs.nr)
        m = max(self.ray_multiple, 1)
        with self._exec_ctx():
            if ctl.ip == 1 and 0 < pack < obs.nr:
                self._formod_packaged(atm, obs,
                                      self.package_size(obs.nr, pack))
            else:
                r = obs.nr
                obs_run = pad_obs(obs, -(-r // m) * m)
                los = (self.trace(atm, obs_run) if ctl.ip == 1
                       else self.pencil_trace(atm, obs_run))
                out = self.integrate(los)
                (obs.rad, obs.tau, obs.tpz, obs.tplon,
                 obs.tplat) = self._outputs_to_host(
                     (out.rad, out.tau, los.tpz, los.tplon, los.tplat), r)
        formod_fov(ctl, obs)
        obs.rad[mask] = np.nan                        # apply_mask
        return obs

    def _outputs_to_host(self, arrays, r):
        """All per-call outputs in ONE device->host transfer (the
        analogue of the reference's one D2H obs copy per package,
        GPUdrivers.cu:244)."""
        return self._outputs_to_host_many([(arrays, r)])[0]

    def _outputs_to_host_many(self, items):
        """Batched form of :meth:`_outputs_to_host` over a package list
        ``[(arrays, r), ...]``: every package's outputs join a single
        ``jax.device_get``.  Overridden by the sharded model (allgather
        path).  ``np.array`` (not asarray): device_get may hand back
        read-only buffers, and formod mutates the outputs in place."""
        pulled_all = jax.device_get([tuple(a) for a, _ in items])
        return [tuple(np.array(x[:r], np.float64) for x in pulled)
                for pulled, (_, r) in zip(pulled_all, items)]

    def _formod_packaged(self, atm: Atm, obs: Obs, pack: int) -> None:
        """Pipelined package loop: enqueue trace+integrate per package
        (device, async), only then pull results to host.  The last
        package is padded by repeating the final ray so every package
        shares one compiled shape."""
        import dataclasses as dc
        hydrostatic_atm(self.ctl, atm)               # once, up front
        R = obs.nr
        handles = []
        for start in range(0, R, pack):
            idx = np.minimum(np.arange(start, start + pack), R - 1)
            obs_k = Obs(**{
                f.name: np.ascontiguousarray(getattr(obs, f.name)[idx])
                for f in dc.fields(Obs)})
            los_k = self.trace(atm, obs_k, hydro=False)  # prep + enqueue
            out_k = self.integrate(los_k)            # enqueue
            handles.append((min(pack, R - start), los_k, out_k))
        # ONE device_get for every package's outputs
        results = self._outputs_to_host_many(
            [((out_k.rad, out_k.tau, los_k.tpz, los_k.tplon,
               los_k.tplat), n) for n, los_k, out_k in handles])
        (obs.rad, obs.tau, obs.tpz, obs.tplon,
         obs.tplat) = (np.concatenate(x) for x in zip(*results))


def formod(ctl: Ctl, atm: Atm, obs: Obs, tables: EgaTables | None = None,
           directory: str = ".", dtype=None) -> Obs:
    """One-shot forward model (formod, CPUdrivers.c:179)."""
    if ctl.checkmode:
        print(f"# formod: checkmode = {ctl.checkmode}, "
              "no actual computation is performed!")
        return obs
    return ForwardModel(ctl, tables, directory, dtype).formod(atm, obs)
