"""Ray tracing through the spherical-shell atmosphere.

A JAX re-expression of the reference raytracer (``traceray``,
jr_common.h:586-711) and its helpers: instead of a per-ray C loop with
early exit, rays are traced with a fixed-length ``lax.scan`` over the LOS
step budget, ``vmap``-ed over the ray batch; data-dependent termination
(ground/space escape) becomes a carried ``stopped`` mask.  The function is
dtype-parametric: float64 gives bit-faithful parity with the reference on
CPU, float32 is the fast path on the GPU.

Semantics replicated exactly (each with its reference citation):

* observer-above-atmosphere entry-point bisection  (jr_common.h:610-621)
* step length ds = min(RAYDS, RAYDZ/|cos a|)       (jr_common.h:625-635)
* escape clipping to zmin/zmax with the *previous* segment shortened by
  the fractional step and the boundary point appended with ds=0
  (jr_common.h:637-648); the previous point is reconstructed from its
  stored geodetic coordinates, not its Cartesian position
* refraction bending below 60 km via the refractivity gradient at the
  half-step midpoint with +0.02 km central offsets (jr_common.h:664-690)
* lowest-altitude tracking for the tangent point, parabola fit through
  the three points around the minimum — including the reference's use of
  ds[ip] (the segment *leaving* point ip) as the chord length between
  points ip-1 and ip (jr_common.h:503-539)
* trapezoid-rule segment lengths and column densities
  u = 10 q p / (k_B T) ds  (jr_common.h:438-453)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import Ctl
from .constants import KB, RE
from .io_tab import Atm, Obs

DEG2RAD = np.pi / 180.0
RAD2DEG = 180.0 / np.pi
Z_REFRAC = 60.0  # refraction considered below this altitude [km]


# ---------------------------------------------------------------------------
# Elementary geometry (geo2cart/cart2geo, jr_common.h:483-500)

def geo2cart(alt, lon, lat):
    radius = alt + RE
    clat = jnp.cos(lat * DEG2RAD)
    return jnp.stack([
        radius * clat * jnp.cos(lon * DEG2RAD),
        radius * clat * jnp.sin(lon * DEG2RAD),
        radius * jnp.sin(lat * DEG2RAD),
    ], axis=-1)


def cart2geo(x):
    radius = jnp.sqrt(jnp.sum(x * x, axis=-1))
    lat = jnp.arcsin(x[..., 2] / radius) * RAD2DEG
    lon = jnp.arctan2(x[..., 1], x[..., 0]) * RAD2DEG
    return radius - RE, lon, lat


def gravity(z, lat):
    """Latitude/altitude-dependent gravity (jr_common.h:213-217)."""
    x = jnp.sin(lat * DEG2RAD)
    y = jnp.sin(2 * lat * DEG2RAD)
    return 9.780318 * (1.0 + 0.0053024 * x * x - 5.8e-6 * y * y) - 3.086e-3 * z


def refractivity(p, t):
    """n - 1 of air at 4-15 um (jr_common.h:476-477)."""
    return 7.753e-05 * p / t


# ---------------------------------------------------------------------------
# Per-ray atmospheric profiles (host-side preparation)

class RayProfiles(NamedTuple):
    """Per-ray vertical profiles, padded to a common level count.

    The reference selects, per ray, the atm time block via ``locate_atm``
    (jr_common.h:128-154) and interpolates 1-D in altitude over that whole
    window (``intpol_atm_1d``, jr_common.h:550-567); zmin/zmax come from
    the window's leading constant-(lon,lat) run (``altitude_range_nn``,
    jr_common.h:412-420).  Here that selection happens once on the host,
    producing dense per-ray arrays for the jitted tracer.
    """

    z: jax.Array      # [R, L]  (padded ascending)
    p: jax.Array      # [R, L]
    t: jax.Array      # [R, L]
    q: jax.Array      # [R, G, L]
    k: jax.Array      # [R, W, L]
    nlev: jax.Array   # [R] int32
    zmin: jax.Array   # [R]
    zmax: jax.Array   # [R]


def locate_atm(time_arr: np.ndarray, time: float) -> tuple[int, int]:
    """Time-block bisection (locate_atm, jr_common.h:128-154)."""
    n = time_arr.size
    lo, hi = 0, n - 1
    while hi > lo + 1:
        i = (lo + hi) // 2
        if time_arr[i] < time:
            lo = i
        else:
            hi = i
    lower = lo if lo == 0 else hi
    lo, hi = lower, n - 1
    while hi > lo + 1:
        i = (lo + hi) // 2
        if time_arr[i] > time:
            hi = i
        else:
            lo = i
    upper = n if hi == n - 1 else hi
    return lower, upper - lower


def ray_window_indices(atm: Atm, obs: Obs):
    """Per-ray atm window (time-block bisection per unique time stamp):
    (idx, cnt, gi) with gi the [R, L] clamped gather index matrix that
    maps the flat atm point axis onto per-ray profiles."""
    nr = obs.nr
    idx = np.zeros(nr, dtype=np.int64)
    cnt = np.zeros(nr, dtype=np.int64)
    # rays within one scan share the time stamp: bisect once per unique
    win_cache: dict = {}
    for ir in range(nr):
        key = float(obs.time[ir])
        if key not in win_cache:
            win_cache[key] = locate_atm(atm.time, key)
        idx[ir], cnt[ir] = win_cache[key]
    L = int(cnt.max())
    ar = np.arange(L)
    gi = np.minimum(idx[:, None] + ar, idx[:, None] + cnt[:, None] - 1)
    return idx, cnt, gi


def build_ray_profiles(ctl: Ctl, atm: Atm, obs: Obs,
                       dtype=jnp.float64) -> RayProfiles:
    if ctl.ip != 1:
        raise NotImplementedError(
            "Only IP=1 (vertical profile) is supported on the accelerated "
            "path, matching the reference device path "
            "(jr_common.h:573,581). ForwardModel dispatches IP=2/3 to the "
            "host pencil path (ForwardModel.pencil_trace) automatically.")
    nr = obs.nr
    idx, cnt, gi = ray_window_indices(atm, obs)
    L = gi.shape[1]

    # vectorized window gather with clamped indices; padding beyond each
    # window keeps the last level (and an ascending z so the interval
    # search stays clamped)
    ar = np.arange(L)
    pad = ar[None, :] >= cnt[:, None]
    z = atm.z[gi] + np.where(pad, (ar[None, :] - cnt[:, None] + 1) * 1e6, 0.0)
    p = atm.p[gi]
    t = atm.t[gi]
    q = np.swapaxes(atm.q[:, gi], 0, 1)          # [R, G, L]
    k = np.swapaxes(atm.k[:, gi], 0, 1)          # [R, W, L]

    # altitude_range_nn: constant-(lon,lat) leading run of each window
    zmin = np.zeros(nr)
    zmax = np.zeros(nr)
    run_cache: dict = {}
    for ir in range(nr):
        i0, n = int(idx[ir]), int(cnt[ir])
        if (i0, n) not in run_cache:
            diff = np.nonzero((atm.lon[i0:i0 + n] != atm.lon[i0])
                              | (atm.lat[i0:i0 + n] != atm.lat[i0]))[0]
            run = int(diff[0]) if diff.size else n
            zz = atm.z[i0:i0 + run]
            run_cache[(i0, n)] = (zz.min(), zz.max())
        zmin[ir], zmax[ir] = run_cache[(i0, n)]
    return RayProfiles(
        z=jnp.asarray(z, dtype), p=jnp.asarray(p, dtype),
        t=jnp.asarray(t, dtype), q=jnp.asarray(q, dtype),
        k=jnp.asarray(k, dtype),
        nlev=jnp.asarray(cnt, jnp.int32),
        zmin=jnp.asarray(zmin, dtype), zmax=jnp.asarray(zmax, dtype))


# ---------------------------------------------------------------------------
# Profile interpolation (intpol_atm_1d, jr_common.h:550-567)

def _interval_index(zgrid, nlev, z0):
    """Index ilo in [0, nlev-2] with z[ilo] <= z0 < z[ilo+1] (clamped),
    identical to locate() for ascending grids (jr_common.h:88-104).
    Computed as a branch-free compare-sum: no data-dependent search."""
    below = (zgrid <= z0).astype(jnp.int32)
    return jnp.clip(jnp.sum(below) - 1, 0, nlev - 2)


def _interval_onehots(zgrid, nlev, z0):
    """One-hot rows of the bracketing levels (ilo, ilo+1).  Level
    values are then extracted with :func:`_pick` masked sums instead of
    dynamic indexing: under the ray vmap a per-ray ``arr[i]`` becomes
    an XLA gather, while the one-hot reduce fuses with its neighbours
    (which of the two is faster on the GPU is not measured yet).
    Exactly one term is nonzero, so the extraction is bit-exact in any
    dtype."""
    i = _interval_index(zgrid, nlev, z0)
    iota = jnp.arange(zgrid.shape[-1])
    return iota == i, iota == (i + 1)


def _pick(oh, arr):
    """arr[i] as a one-hot masked sum over the last axis (see
    :func:`_interval_onehots`)."""
    return jnp.sum(jnp.where(oh, arr, 0), axis=-1)


def _lin(x0, y0, x1, y1, x):
    return y0 + (x - x0) * (y1 - y0) / (x1 - x0)


def _eip(x0, y0, x1, y1, x):
    """Exponential interpolation with linear fallback (jr_common.h:52-57)."""
    ok = (y0 > 0) & (y1 > 0)
    y0s = jnp.where(ok, y0, 1.0)
    y1s = jnp.where(ok, y1, 1.0)
    e = y0s * jnp.exp(jnp.log(y1s / y0s) / (x1 - x0) * (x - x0))
    return jnp.where(ok, e, _lin(x0, y0, x1, y1, x))


def interp_pt(prof_z, prof_p, prof_t, nlev, z0):
    lo, hi = _interval_onehots(prof_z, nlev, z0)
    z0_, z1_ = _pick(lo, prof_z), _pick(hi, prof_z)
    p = _eip(z0_, _pick(lo, prof_p), z1_, _pick(hi, prof_p), z0)
    t = _lin(z0_, _pick(lo, prof_t), z1_, _pick(hi, prof_t), z0)
    return p, t


def interp_qk(prof_z, prof_q, prof_k, nlev, z0):
    lo, hi = _interval_onehots(prof_z, nlev, z0)
    z0_, z1_ = _pick(lo, prof_z), _pick(hi, prof_z)
    q = _lin(z0_, _pick(lo, prof_q), z1_, _pick(hi, prof_q), z0)
    k = _lin(z0_, _pick(lo, prof_k), z1_, _pick(hi, prof_k), z0)
    return q, k


def interp_all(prof, z0):
    """interp_pt + interp_qk with ONE shared interval search (they are
    always called at the same altitude in the tracer step; the
    compare-sum over the level grid is the step's dominant cost)."""
    lo, hi = _interval_onehots(prof.z, prof.nlev, z0)
    za, zb = _pick(lo, prof.z), _pick(hi, prof.z)
    p = _eip(za, _pick(lo, prof.p), zb, _pick(hi, prof.p), z0)
    t = _lin(za, _pick(lo, prof.t), zb, _pick(hi, prof.t), z0)
    q = _lin(za, _pick(lo, prof.q), zb, _pick(hi, prof.q), z0)
    k = _lin(za, _pick(lo, prof.k), zb, _pick(hi, prof.k), z0)
    return p, t, q, k


# ---------------------------------------------------------------------------
# Line-of-sight result container

class LosData(NamedTuple):
    """Traced lines of sight, fixed shape [R, NLOS(, ...)]."""

    z: jax.Array       # [R, NLOS]
    lon: jax.Array
    lat: jax.Array
    p: jax.Array
    t: jax.Array
    q: jax.Array       # [R, NLOS, G]
    k: jax.Array       # [R, NLOS, W]
    ds: jax.Array      # [R, NLOS] trapezoid-rule segment lengths
    u: jax.Array       # [R, NLOS, G] column densities [molec/cm^2]
    valid: jax.Array   # [R, NLOS] bool
    np_: jax.Array     # [R] int32 number of LOS points
    tsurf: jax.Array   # [R] surface temperature, -999 if no ground hit
    tpz: jax.Array     # [R] tangent point
    tplon: jax.Array
    tplat: jax.Array


def _trace_single(ctl_rayds, ctl_raydz, ctl_refrac, nlos,
                  prof: RayProfiles, obsz, obslon, obslat,
                  vpz, vplon, vplat, dtype):
    """Trace one ray (to be vmapped).  prof fields are this ray's rows."""
    one = jnp.asarray(1.0, dtype)
    zero = jnp.asarray(0.0, dtype)

    xobs = geo2cart(obsz, obslon, obslat)
    xvp = geo2cart(vpz, vplon, vplat)
    ex0 = xvp - xobs
    norm = jnp.sqrt(jnp.sum(ex0 * ex0))
    ex0 = ex0 / norm

    # Ray is traced only when the observer is above zmin and the view point
    # below zmax - 0.001 (jr_common.h:598-599)
    ok = (obsz >= prof.zmin) & (vpz <= prof.zmax - 0.001)

    # Observer above atmosphere: bisect the entry point (jr_common.h:610-621)
    def entry_point(x):
        def cond(s):
            dmin, dmax, x, found = s
            return (jnp.abs(dmin - dmax) > 0.001) & jnp.logical_not(found)

        def body(s):
            dmin, dmax, x, _ = s
            d = 0.5 * (dmax + dmin)
            xn = xobs + d * ex0
            z = jnp.sqrt(jnp.sum(xn * xn)) - RE
            found = (z <= prof.zmax) & (z > prof.zmax - 0.001)
            dmax = jnp.where((~found) & (z < prof.zmax - 0.0005), d, dmax)
            dmin = jnp.where((~found) & (z >= prof.zmax - 0.0005), d, dmin)
            return dmin, dmax, xn, found

        _, _, xn, _ = jax.lax.while_loop(
            cond, body, (zero, norm, x, jnp.asarray(False)))
        return xn

    x0 = jnp.where(obsz > prof.zmax, entry_point(xobs), xobs)

    big = jnp.asarray(jnp.inf, dtype)  # z_low sentinel (dtype-safe 1e99)

    def step(carry, ip):
        (x, ex, stopped, stop_code, tsurf, z_low, z_low_idx,
         pz, plon, plat) = carry

        # Step length (jr_common.h:625-635)
        ds = jnp.asarray(ctl_rayds, dtype)
        if ctl_raydz > 0.0:
            norm_x = 1.0 / jnp.sqrt(jnp.sum(x * x))
            cosa = jnp.abs(jnp.sum(ex * x) * norm_x)
            ds = jnp.where(cosa != 0.0,
                           jnp.minimum(ds, ctl_raydz / cosa), ds)

        z, lon, lat = cart2geo(x)

        # Escape clipping (jr_common.h:637-648)
        escaped = (z < prof.zmin) | (z > prof.zmax)
        new_stop = jnp.where(z < prof.zmin, 2, 1)
        xh = geo2cart(pz, plon, plat)
        zfrac = jnp.where(z < prof.zmin, prof.zmin, prof.zmax)
        frac = (zfrac - pz) / jnp.where(z == pz, one, z - pz)
        xe = xh + frac * (x - xh)
        ze, lone, late = cart2geo(xe)
        # segment correction for the previous point, applied post-scan
        ds_corr = jnp.where(escaped, ds * frac, jnp.nan)

        x = jnp.where(escaped, xe, x)
        z = jnp.where(escaped, ze, z)
        lon = jnp.where(escaped, lone, lon)
        lat = jnp.where(escaped, late, lat)
        ds = jnp.where(escaped, zero, ds)

        p, t, q, k = interp_all(prof, z)

        active = ok & jnp.logical_not(stopped)
        is_low = active & (z < z_low)
        z_low = jnp.where(is_low, z, z_low)
        z_low_idx = jnp.where(is_low, ip, z_low_idx)

        stopping = active & escaped
        tsurf = jnp.where(stopping & (new_stop == 2), t, tsurf)
        stop_code = jnp.where(stopping, new_stop, stop_code)

        out = dict(z=z, lon=lon, lat=lat, p=p, t=t, q=q, k=k, ds=ds,
                   ds_corr=jnp.where(stopping, ds_corr, jnp.nan),
                   valid=active)

        # Direction update with optional refraction (jr_common.h:664-690)
        n = one
        ng = jnp.zeros(3, dtype)
        if ctl_refrac:
            def refr_grad(_):
                # only the altitude is needed here; cart2geo's z is
                # exactly |x| - RE, so skip its arcsin/arctan2
                nn = one + refractivity(p, t)
                xh2 = x + 0.5 * ds * ex
                z2 = jnp.sqrt(jnp.sum(xh2 * xh2)) - RE
                p2, t2 = interp_pt(prof.z, prof.p, prof.t, prof.nlev, z2)
                n2 = refractivity(p2, t2)
                h = jnp.asarray(0.02, dtype)

                def axis_grad(i):
                    xp = xh2.at[i].add(h)
                    zp = jnp.sqrt(jnp.sum(xp * xp)) - RE
                    pp, tp = interp_pt(prof.z, prof.p, prof.t, prof.nlev, zp)
                    return (refractivity(pp, tp) - n2) / h

                g = jnp.stack([axis_grad(0), axis_grad(1), axis_grad(2)])
                return nn, g

            use_refrac = z <= Z_REFRAC
            nn, g = refr_grad(None)
            n = jnp.where(use_refrac, nn, one)
            ng = jnp.where(use_refrac, g, ng)

        ex1 = ex * n + ds * ng
        ex1 = ex1 / jnp.sqrt(jnp.sum(ex1 * ex1))
        x_new = x + 0.5 * ds * (ex + ex1)

        advance = active & jnp.logical_not(stopping)
        x = jnp.where(advance, x_new, x)
        ex = jnp.where(advance, ex1, ex)
        stopped = stopped | stopping | jnp.logical_not(ok)

        return (x, ex, stopped, stop_code, tsurf, z_low, z_low_idx,
                z, lon, lat), out

    init = (x0, ex0, jnp.logical_not(ok), jnp.asarray(0, jnp.int32),
            jnp.asarray(-999.0, dtype), big, jnp.asarray(-1, jnp.int32),
            zero, zero, zero)
    # unroll: the per-step state is tiny, so the 400-step scan is bound
    # by per-step loop overhead; unrolling amortizes the loop boundaries
    # without changing any per-element arithmetic (the factor is not
    # tuned for the GPU yet)
    carry, outs = jax.lax.scan(step, init,
                               jnp.arange(nlos, dtype=jnp.int32),
                               unroll=8)
    (_, _, _, _, tsurf, _, z_low_idx, _, _, _) = carry

    valid = outs["valid"]
    np_ = jnp.sum(valid.astype(jnp.int32))

    # Apply the escape segment-length correction to the point before the
    # boundary point (los[np-1].ds = ds*frac, jr_common.h:646)
    ds = outs["ds"]
    corr = outs["ds_corr"]
    has_corr = jnp.logical_not(jnp.isnan(corr))
    corr_idx = jnp.argmax(has_corr)  # at most one per ray
    any_corr = jnp.any(has_corr)
    ds = jnp.where(
        any_corr & (jnp.arange(nlos) == corr_idx - 1),
        jnp.where(any_corr, corr[corr_idx], zero), ds)

    # Tangent point from the pre-trapezoid segment lengths
    # (tangent_point, jr_common.h:503-539)
    ipl = z_low_idx
    zarr, lonarr, latarr = outs["z"], outs["lon"], outs["lat"]
    limb_case = (ipl > 0) & (ipl < np_ - 1)
    ips = jnp.clip(ipl, 1, nlos - 2)
    yy0, yy1, yy2 = zarr[ips - 1], zarr[ips], zarr[ips + 1]
    ds0, ds1 = ds[ips], ds[ips + 1]
    dyy10, dyy21 = yy1 - yy0, yy2 - yy1
    x1 = jnp.sqrt(jnp.maximum(ds0 * ds0 - dyy10 * dyy10, zero))
    x2 = x1 + jnp.sqrt(jnp.maximum(ds1 * ds1 - dyy21 * dyy21, zero))
    dx12 = x1 - x2
    denom = jnp.where(limb_case, x1 * x2 * dx12, one)
    a = (dyy10 * x2 + (yy0 - yy2) * x1) / denom
    b = dyy10 / jnp.where(limb_case, x1, one) - a * x1
    c = yy0
    xt = -b / (2 * jnp.where(a == 0, one, a))
    tpz_limb = (a * xt + b) * xt + c
    v0 = geo2cart(zarr[ips - 1], lonarr[ips - 1], latarr[ips - 1])
    v2 = geo2cart(zarr[ips + 1], lonarr[ips + 1], latarr[ips + 1])
    v = v0 + (v2 - v0) * (xt / jnp.where(x2 == 0, one, x2))
    _, tplon_limb, tplat_limb = cart2geo(v)

    last = jnp.clip(np_ - 1, 0, nlos - 1)
    tpz = jnp.where(limb_case, tpz_limb, zarr[last])
    tplon = jnp.where(limb_case, tplon_limb, lonarr[last])
    tplat = jnp.where(limb_case, tplat_limb, latarr[last])
    # Rays that never traced keep the view point (jr_common.h:592-594)
    tpz = jnp.where(ok, tpz, vpz)
    tplon = jnp.where(ok, tplon, vplon)
    tplat = jnp.where(ok, tplat, vplat)

    # Trapezoid rule (jr_common.h:438-443): ds'[i] = (ds[i-1]+ds[i])/2,
    # ds'[0] = ds[0]/2 — vectorized over the step axis.
    ds_prev = jnp.concatenate([jnp.zeros(1, dtype), ds[:-1]])
    ds_trap = 0.5 * (ds_prev + ds)

    # Column densities (jr_common.h:446-453).  10/KB is folded into one
    # constant: (KB*T)**2 underflows float32, so the quotient rule of
    # q p / (KB T) made the float32 temperature derivative infinite
    u = ((10.0 / KB) * outs["q"] * outs["p"][:, None]
         / outs["t"][:, None] * ds_trap[:, None])

    return LosData(
        z=zarr, lon=lonarr, lat=latarr, p=outs["p"], t=outs["t"],
        q=outs["q"], k=outs["k"], ds=ds_trap, u=u, valid=valid,
        np_=np_, tsurf=jnp.where(ok, tsurf, jnp.asarray(-999.0, dtype)),
        tpz=tpz, tplon=tplon, tplat=tplat)


from functools import partial


@partial(jax.jit, static_argnames=("rayds", "raydz", "refrac", "nlos",
                                   "dtype"))
def _trace_rays_jit(prof, obs_geo, rayds, raydz, refrac, nlos, dtype):
    f = lambda pz, pp, pt, pq, pk, nl, zmn, zmx, oz, olon, olat, vz, vlon, vlat: \
        _trace_single(
            rayds, raydz, refrac, nlos,
            RayProfiles(pz, pp, pt, pq, pk, nl, zmn, zmx),
            oz, olon, olat, vz, vlon, vlat, dtype)
    return jax.vmap(f)(
        prof.z, prof.p, prof.t, prof.q, prof.k, prof.nlev, prof.zmin,
        prof.zmax,
        obs_geo["obsz"], obs_geo["obslon"], obs_geo["obslat"],
        obs_geo["vpz"], obs_geo["vplon"], obs_geo["vplat"])


def trace_rays(ctl: Ctl, prof: RayProfiles, obs_geo: dict,
               dtype=jnp.float64) -> LosData:
    """Trace all rays: vmapped fixed-step scan (raytrace_rays_CPU,
    CPUdrivers.c:89-95 / raytrace_rays_GPU thread-per-ray,
    GPUdrivers.cu:151-157)."""
    return _trace_rays_jit(prof, obs_geo, float(ctl.rayds),
                           float(ctl.raydz), bool(ctl.refrac),
                           int(ctl.nlos), dtype)


# ---------------------------------------------------------------------------
# Hydrostatic equilibrium (hydrostatic_1d_h2o, jr_common.h:728-761)

def hydrostatic_profile(ctl_hydz: float, z: np.ndarray, p: np.ndarray,
                        t: np.ndarray, q_h2o, lat: np.ndarray) -> np.ndarray:
    """Rebuild p(z) from temperature and humidity around the reference
    height; NumPy float64 host implementation (profiles are small)."""
    from .constants import MM_AIR, MM_H2O, RGAS
    n = z.size
    ipref = int(np.argmin(np.abs(z - ctl_hydz)))
    lat0 = lat[ipref]
    npts = 20
    i = np.arange(npts)
    p = p.copy()

    def layer_mean(za, zb, ta, tb, ea, eb):
        zz = za + (zb - za) * i / (npts - 1.0)
        ee = ea + (eb - ea) * i / (npts - 1.0)
        tt = ta + (tb - ta) * i / (npts - 1.0)
        grav = (9.780318 * (1.0 + 0.0053024 * np.sin(lat0 * DEG2RAD) ** 2
                            - 5.8e-6 * np.sin(2 * lat0 * DEG2RAD) ** 2)
                - 3.086e-3 * zz)
        return np.sum((ee * MM_H2O + (1 - ee) * MM_AIR) * grav
                      / (RGAS * tt * npts))

    e = np.zeros(n) if q_h2o is None else q_h2o
    for ip in range(ipref + 1, n):
        mean = layer_mean(z[ip - 1], z[ip], t[ip - 1], t[ip],
                          e[ip - 1], e[ip])
        p[ip] = p[ip - 1] * np.exp(-1000.0 * mean * (z[ip] - z[ip - 1]))
    for ip in range(ipref - 1, -1, -1):
        mean = layer_mean(z[ip + 1], z[ip], t[ip + 1], t[ip],
                          e[ip + 1], e[ip])
        p[ip] = p[ip + 1] * np.exp(-1000.0 * mean * (z[ip] - z[ip + 1]))
    return p


def hydrostatic_profile_jnp(ctl_hydz: float, z: np.ndarray, p, t, q_h2o,
                            lat0: float):
    """Differentiable hydrostatic rebuild (hydrostatic_1d_h2o,
    jr_common.h:728-761) for the autodiff retrieval path.

    The reference's two sequential recursions
    ``p[ip] = p[ip∓1] * exp(-1000 * mean * (z[ip] - z[ip∓1]))`` are a
    cumulative sum in log-pressure around the (static) reference level,
    so the whole rebuild vectorizes to one cumsum — no ``lax.scan``
    carry needed.  ``z``/``lat0`` are static host values; ``p``/``t``/
    ``q_h2o`` may be traced.
    """
    from .constants import MM_AIR, MM_H2O, RGAS
    z = np.asarray(z, np.float64)
    ipref = int(np.argmin(np.abs(z - ctl_hydz)))
    npts = 20
    w = np.arange(npts) / (npts - 1.0)                       # [S]
    e = jnp.zeros_like(t) if q_h2o is None else q_h2o
    # per-layer mean of (molar mass * g / RT) sampled at npts points
    zz = z[:-1, None] + (z[1:] - z[0:-1])[:, None] * w       # [L, S]
    tt = t[:-1, None] + (t[1:] - t[:-1])[:, None] * w
    ee = e[:-1, None] + (e[1:] - e[:-1])[:, None] * w
    grav = (9.780318 * (1.0 + 0.0053024 * np.sin(lat0 * DEG2RAD) ** 2
                        - 5.8e-6 * np.sin(2 * lat0 * DEG2RAD) ** 2)
            - 3.086e-3 * zz)
    mean = jnp.sum((ee * MM_H2O + (1 - ee) * MM_AIR) * grav
                   / (RGAS * tt * npts), axis=1)             # [L]
    inc = 1000.0 * mean * (z[1:] - z[:-1])                   # [L]
    c = jnp.concatenate([jnp.zeros((1,), inc.dtype), jnp.cumsum(inc)])
    logp = jnp.log(p[ipref]) - (c - c[ipref])
    return jnp.exp(logp)


def hydrostatic_atm(ctl: Ctl, atm: Atm) -> Atm:
    """Apply hydrostatic equilibrium to each (lon,lat,time) profile in atm
    (hydrostatic, jurassic.c:263-276)."""
    if ctl.hydz < 0:
        return atm
    if ctl.checkmode:
        print("# apply hydrostatic equation to individual profiles")
        return atm
    ig_h2o = ctl.emitter_index("H2O")
    lon0 = lat0 = -999.0
    ip0 = 0
    bounds = []
    for ip in range(atm.npts):
        if atm.lon[ip] != lon0 or atm.lat[ip] != lat0:
            if ip > 0:
                bounds.append((ip0, ip))
            lon0, lat0, ip0 = atm.lon[ip], atm.lat[ip], ip
    bounds.append((ip0, atm.npts))
    for (a, b) in bounds:
        qh = atm.q[ig_h2o, a:b] if ig_h2o >= 0 else None
        atm.p[a:b] = hydrostatic_profile(
            ctl.hydz, atm.z[a:b], atm.p[a:b], atm.t[a:b], qh, atm.lat[a:b])
    return atm
