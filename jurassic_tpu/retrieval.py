"""Retrieval interface: state/measurement vectors and Jacobians.

Re-expression of the reference's retrieval API (C19 in SURVEY.md):

* state-vector pack/unpack ``atm2x``/``x2atm`` (jurassic.c:1491-1513,
  1473-1488) selecting pressure/temperature/vmr/extinction grid points
  inside the configured retrieval altitude ranges;
* measurement-vector pack/unpack ``obs2y``/``y2obs``
  (jurassic.c:1528-1541, 1516-1526) over finite radiance cells;
* the finite-difference Jacobian ``kernel`` (jurassic.c:812-857) with the
  reference's per-quantity perturbation sizes — the parity oracle;
* :func:`kernel_autodiff`: one ``jax.jacfwd``
  through the jitted raytrace + RT integration, exact derivatives in a
  single compiled pass instead of n+1 forward models.

GSL vectors/matrices become plain NumPy arrays.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np

from .config import Ctl
from .io_tab import Atm, Obs

if TYPE_CHECKING:
    from .forward import ForwardModel

# Quantity indices (IDXP/IDXT/IDXQ/IDXK, jurassic.h:200-209)
IDXP = 0
IDXT = 1


def idxq(ig: int) -> int:
    return 2 + ig


def idxk(ctl: Ctl, iw: int) -> int:
    return 2 + ctl.ng + iw


def idx2name(ctl: Ctl, idx: int) -> str:
    """Quantity index -> name (idx2name, jurassic.c:1300-1307)."""
    if idx == IDXP:
        return "PRESSURE"
    if idx == IDXT:
        return "TEMPERATURE"
    if 2 <= idx < 2 + ctl.ng:
        return ctl.emitter[idx - 2]
    if 2 + ctl.ng <= idx < 2 + ctl.ng + ctl.nw:
        return f"EXTINCT_WINDOW{idx - 2 - ctl.ng}"
    raise ValueError(f"Unknown quantity index {idx}")


def _ranges(ctl: Ctl):
    """(zmin, zmax, quantity-index) triplets in reference pack order."""
    out = [(ctl.retp_zmin, ctl.retp_zmax, IDXP),
           (ctl.rett_zmin, ctl.rett_zmax, IDXT)]
    out += [(ctl.retq_zmin[ig], ctl.retq_zmax[ig], idxq(ig))
            for ig in range(ctl.ng)]
    out += [(ctl.retk_zmin[iw], ctl.retk_zmax[iw], idxk(ctl, iw))
            for iw in range(ctl.nw)]
    return out


def _field(atm: Atm, iqa: int, ctl: Ctl) -> np.ndarray:
    if iqa == IDXP:
        return atm.p
    if iqa == IDXT:
        return atm.t
    if iqa < 2 + ctl.ng:
        return atm.q[iqa - 2]
    return atm.k[iqa - 2 - ctl.ng]


def atm2x(ctl: Ctl, atm: Atm):
    """Pack the state vector (atm2x, jurassic.c:1491-1513).

    Returns (x, iqa, ipa): values, quantity indices, grid-point indices."""
    xs, iqas, ipas = [], [], []
    for zmin, zmax, iqa in _ranges(ctl):
        sel = np.nonzero((atm.z >= zmin) & (atm.z <= zmax))[0]
        xs.append(_field(atm, iqa, ctl)[sel])
        iqas.append(np.full(sel.size, iqa, np.int32))
        ipas.append(sel.astype(np.int32))
    return (np.concatenate(xs) if xs else np.zeros(0),
            np.concatenate(iqas) if iqas else np.zeros(0, np.int32),
            np.concatenate(ipas) if ipas else np.zeros(0, np.int32))


def x2atm(ctl: Ctl, x: np.ndarray, atm: Atm) -> Atm:
    """Unpack a state vector into atm in place (x2atm,
    jurassic.c:1473-1488)."""
    n = 0
    for zmin, zmax, iqa in _ranges(ctl):
        sel = np.nonzero((atm.z >= zmin) & (atm.z <= zmax))[0]
        _field(atm, iqa, ctl)[sel] = x[n:n + sel.size]
        n += sel.size
    if n != x.size:
        raise ValueError(f"State vector size mismatch: {x.size} != {n}")
    return atm


def obs2y(ctl: Ctl, obs: Obs):
    """Pack the measurement vector over finite radiances (obs2y,
    jurassic.c:1528-1541).  Returns (y, ida, ira)."""
    finite = np.isfinite(obs.rad)                  # [R, D]
    ira, ida = np.nonzero(finite)
    return obs.rad[ira, ida], ida.astype(np.int32), ira.astype(np.int32)


def y2obs(ctl: Ctl, y: np.ndarray, obs: Obs) -> Obs:
    """Unpack a measurement vector into obs.rad in place (y2obs,
    jurassic.c:1516-1526)."""
    finite = np.isfinite(obs.rad)
    if y.size != int(finite.sum()):
        raise ValueError("Measurement vector size mismatch")
    obs.rad[finite] = y
    return obs


def perturbation_sizes(ctl: Ctl, x0: np.ndarray,
                       iqa: np.ndarray) -> np.ndarray:
    """Reference per-quantity FD steps (kernel, jurassic.c:833-836):
    pressure max(|1% x|, 1e-7), temperature 1 K, vmr max(|1% x|, 1e-15),
    extinction 1e-4."""
    h = np.empty_like(x0)
    h[iqa == IDXP] = np.maximum(np.abs(0.01 * x0[iqa == IDXP]), 1e-7)
    h[iqa == IDXT] = 1.0
    isq = (iqa >= 2) & (iqa < 2 + ctl.ng)
    h[isq] = np.maximum(np.abs(0.01 * x0[isq]), 1e-15)
    h[iqa >= 2 + ctl.ng] = 1e-4
    return h


def kernel(ctl: Ctl, atm: Atm, obs: Obs,
           model: Optional["ForwardModel"] = None) -> np.ndarray:
    """Finite-difference Jacobian K[m, n] = d rad / d x
    (kernel, jurassic.c:812-857): n+1 forward models, one per state
    element, with the reference's perturbation sizes."""
    from .forward import ForwardModel
    if model is None:
        model = ForwardModel(ctl)
    model.formod(atm, obs)
    x0, iqa, _ = atm2x(ctl, atm)
    y0, _, _ = obs2y(ctl, obs)
    h = perturbation_sizes(ctl, x0, iqa)
    K = np.zeros((y0.size, x0.size))
    for j in range(x0.size):
        x1 = x0.copy()
        x1[j] += h[j]
        atm1, obs1 = atm.copy(), obs.copy()
        x2atm(ctl, x1, atm1)
        model.formod(atm1, obs1)
        y1, _, _ = obs2y(ctl, obs1)
        K[:, j] = (y1 - y0) / h[j]
    return K


def kernel_autodiff(ctl: Ctl, atm: Atm, obs: Obs,
                    model: Optional["ForwardModel"] = None) -> np.ndarray:
    """Exact Jacobian via ``jax.jacfwd`` through the jitted pipeline.

    The upgrade over the reference's n+1 forward models
    (SURVEY.md 3.4): one compiled forward-mode pass differentiates the
    raytrace (column densities, refraction) and the RT integration jointly.
    Supports the accelerated path's atmosphere model (IP=1): single- OR
    multi-profile atmospheres (satellite-track batches where each scan's
    time stamp selects its profile, locate_atm, jr_common.h:128-154) —
    the state vector scatters into the flat atm point axis and per-ray
    profiles are differentiable gathers through the same window indices
    the tracer uses.  HYDZ >= 0 runs the differentiable hydrostatic
    rebuild (geometry.hydrostatic_profile_jnp) per (lon, lat) profile
    inside the traced graph, so pressure derivatives flow through the
    rebuild exactly as the FD kernel sees them.

    KERNEL-PATH SEAM: this function always differentiates the **jnp scan
    pipeline** (``rt_integrate``), even when ``model`` runs the fused
    kernel for its forward radiances -- the kernel has no derivative
    rule, and the jnp path is the same physics on the same tables.
    Consequently the Jacobian differs from an FD Jacobian computed
    *through the kernel forward* by the kernel-vs-jnp forward deviation
    (~1e-6 relative) divided by the FD step -- well inside the FD
    truncation error for the reference's perturbation sizes (tested:
    test_autodiff_vs_fd_through_pallas).  A model on fast tables
    differentiates the jnp fast path (``ega_eps_fast``); only a
    ``KERNEL = exact`` model differentiates the reference-order exact
    lookups.
    """
    import jax
    import jax.numpy as jnp

    from .forward import ForwardModel, rt_integrate
    from .geometry import (LosData, build_ray_profiles,
                           hydrostatic_profile_jnp, ray_window_indices,
                           trace_rays)
    from .geometry import _trace_rays_jit  # noqa: F401 (compiled cache)

    if model is None:
        model = ForwardModel(ctl)

    mask = ~np.isfinite(obs.rad)
    from .geometry import hydrostatic_atm
    hydrostatic_atm(ctl, atm)   # FD kernel packs x0 post-rebuild, too
    x0, iqa, ipa = atm2x(ctl, atm)
    dtype = model.dtype
    ig_h2o = ctl.emitter_index("H2O")
    # (lon, lat) profile blocks for the in-graph hydrostatic rebuild
    # (same split as hydrostatic_atm / the reference's hydrostatic,
    # jurassic.c:263-276)
    blocks = []
    if ctl.hydz >= 0:
        lon0 = lat0 = -999.0
        ip0 = 0
        for ip in range(atm.npts):
            if atm.lon[ip] != lon0 or atm.lat[ip] != lat0:
                if ip > 0:
                    blocks.append((ip0, ip))
                lon0, lat0, ip0 = atm.lon[ip], atm.lat[ip], ip
        blocks.append((ip0, atm.npts))

    _, _, gi = ray_window_indices(atm, obs)
    gi = jnp.asarray(gi)
    prof0 = build_ray_profiles(ctl, atm, obs, dtype)
    obs_geo = dict(
        obsz=jnp.asarray(obs.obsz, dtype), obslon=jnp.asarray(obs.obslon, dtype),
        obslat=jnp.asarray(obs.obslat, dtype), vpz=jnp.asarray(obs.vpz, dtype),
        vplon=jnp.asarray(obs.vplon, dtype), vplat=jnp.asarray(obs.vplat, dtype))

    # static per-quantity index groups -> one vectorized scatter each
    # (O(1) graph nodes regardless of state size)
    jidx = np.arange(x0.size)
    selp = iqa == IDXP
    selt = iqa == IDXT
    selq = (iqa >= 2) & (iqa < 2 + ctl.ng)
    selk = iqa >= 2 + ctl.ng

    def fwd(x):
        # scatter the state vector into the shared profile: all rays see
        # the one vertical profile, so each x element updates one level
        # across every ray.
        p = jnp.asarray(atm.p, dtype)
        t = jnp.asarray(atm.t, dtype)
        q = jnp.asarray(atm.q, dtype)
        k = jnp.asarray(atm.k, dtype)
        if selp.any():
            p = p.at[ipa[selp]].set(x[jidx[selp]])
        if selt.any():
            t = t.at[ipa[selt]].set(x[jidx[selt]])
        if selq.any():
            q = q.at[iqa[selq] - 2, ipa[selq]].set(x[jidx[selq]])
        if selk.any():
            k = k.at[iqa[selk] - 2 - ctl.ng, ipa[selk]].set(x[jidx[selk]])
        if ctl.hydz >= 0:
            parts = []
            for (a, b) in blocks:
                qh = q[ig_h2o, a:b] if ig_h2o >= 0 else None
                lat_ref = float(atm.lat[a:b][int(np.argmin(
                    np.abs(atm.z[a:b] - ctl.hydz)))])
                parts.append(hydrostatic_profile_jnp(
                    ctl.hydz, atm.z[a:b], p[a:b], t[a:b], qh, lat_ref))
            p = jnp.concatenate(parts)
        # per-ray profiles: differentiable gathers through the same
        # window indices the tracer's host prep uses (multi-profile
        # atmospheres pick each scan's profile by time stamp)
        prof = prof0._replace(
            z=prof0.z, nlev=prof0.nlev, zmin=prof0.zmin, zmax=prof0.zmax,
            p=p[gi],
            t=t[gi],
            q=jnp.moveaxis(q[:, gi], 0, 1),
            k=jnp.moveaxis(k[:, gi], 0, 1))
        los: LosData = trace_rays(ctl, prof, obs_geo, dtype)
        out = rt_integrate(
            model.dev_tbl, model.sr, model.st, model.nu, model.cc,
            model.window, los, los.tsurf, model.flags, model.ig_co2,
            model.ig_h2o, model.use_fast, bool(ctl.write_bbt))
        return jnp.where(jnp.asarray(mask), 0.0, out.rad)

    jac = jax.jit(jax.jacfwd(fwd))(jnp.asarray(x0, dtype))  # [R, D, n]
    finite = ~mask
    return np.asarray(jac)[finite, :].astype(np.float64)
