"""Emissivity Growth Approximation core.

Two implementations of ega_eps (jr_common.h:238-268):

* :func:`ega_eps_exact` -- reference-faithful semantics on the ragged padded
  tables: interval searches replicate locate_id/locate_tbl_id
  (jr_common.h:107-125) as branch-free masked compare-sums, interpolation
  extrapolates linearly at both ends exactly like ``lip`` on the clamped
  index.  With float64 inputs this is the in-repo oracle (the analogue of
  the reference CPU path).

* :func:`ega_eps_fast` -- the production jnp path on
  :class:`~jurassic_tpu.tables.FastTables`: u-axis positions come from
  log2 arithmetic on the exact log-uniform resampled grid (the legitimized
  FAST_INVERSE_OF_U, jurassic.c:487-609), the eps->u inversion from a
  log-uniform optical-depth inverse table.  Remaining memory traffic is
  2-element gathers per (gas, corner, channel).

Both operate on a whole (gas, channel) block [G, D] at once, channels
minor-most like the reference's channel-minor layout.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

import numpy as np

from ..constants import TAU_OPAQUE
from ..tables import LOG2_RATIO_U


def _c01(x):
    """Clamp to [0,1] (c01, jr_common.h:43-45)."""
    return jnp.clip(x, 0.0, 1.0)


def _lip(x0, y0, x1, y1, x):
    """Linear interpolation with a guarded denominator; extrapolates like
    the reference ``lip`` (jr_common.h:48-50)."""
    d = x1 - x0
    d = jnp.where(d == 0, 1.0, d)
    return y0 + (x - x0) * (y1 - y0) / d


def _count_index(values, counts, x, axis):
    """ilo = clip(#\\{values <= x within count\\} - 1, 0, count-2):
    branch-free equivalent of the ascending binary searches
    locate_id/locate_tbl_id (jr_common.h:107-125)."""
    n = values.shape[axis]
    iota = jax.lax.broadcasted_iota(jnp.int32, values.shape, axis)
    cnt = jnp.expand_dims(counts, axis)
    below = (values <= jnp.expand_dims(x, axis)) & (iota < cnt)
    idx = jnp.sum(below.astype(jnp.int32), axis=axis) - 1
    return jnp.clip(idx, 0, jnp.maximum(counts - 2, 0))


def _take1(arr, idx, axis):
    """take_along_axis with a scalar-per-slice index, squeezing the axis."""
    shape = list(arr.shape)
    ind = idx
    for _ in range(arr.ndim - idx.ndim):
        ind = jnp.expand_dims(ind, axis)
    ind = jnp.clip(ind, 0, shape[axis] - 1)
    return jnp.take_along_axis(arr, ind, axis=axis).squeeze(axis)


class EgaDeviceTables(NamedTuple):
    """EgaTables as device arrays in the working dtype (payloads f32)."""

    np_: jax.Array
    nt: jax.Array
    nu: jax.Array
    p: jax.Array
    t: jax.Array
    u: jax.Array
    eps: jax.Array


def ega_eps_exact(tbl: EgaDeviceTables, tau_path, t, u_seg, p):
    """Exact EGA emissivity factor for one LOS segment.

    Args:
      tbl: device tables, axes [G, P, T, U, D].
      tau_path: accumulated per-gas transmittance [G, D].
      t, p: segment temperature / pressure (scalars).
      u_seg: per-gas segment column density [G].

    Returns: factor [G, D] such that tau_path *= factor
    (ega_eps, jr_common.h:238-268).
    """
    G, P, T, U, D = tbl.u.shape
    dtype = tau_path.dtype

    # --- pressure level (ipr) and temperature rows -----------------------
    ipr = _count_index(tbl.p, tbl.np_, jnp.broadcast_to(p, (G, D)), axis=1)

    t_lo = _take1(tbl.t, ipr, axis=1)           # [G, T, D]
    t_hi = _take1(tbl.t, ipr + 1, axis=1)
    nt_lo = _take1(tbl.nt, ipr, axis=1)         # [G, D]
    nt_hi = _take1(tbl.nt, ipr + 1, axis=1)
    tb = jnp.broadcast_to(t, (G, D))
    it0 = _count_index(t_lo, nt_lo, tb, axis=1)
    it1 = _count_index(t_hi, nt_hi, tb, axis=1)

    eps_target = 1.0 - tau_path                  # [G, D]

    def corner(dp, it):
        """One (pressure, temperature) corner: invert eps->u, add the
        segment's u, re-look-up eps (jr_common.h:249-257)."""
        pc = ipr + dp
        u_row = _take1(_take1(tbl.u, pc, axis=1), it, axis=1)      # [G,U,D]
        e_row = _take1(_take1(tbl.eps, pc, axis=1), it, axis=1)
        n_u = _take1(_take1(tbl.nu, pc, axis=1), it, axis=1)       # [G,D]
        u_row = u_row.astype(dtype)
        e_row = e_row.astype(dtype)
        # get_u (jr_common.h:180-185)
        i = _count_index(e_row, n_u, eps_target, axis=1)
        e0, e1 = _take1(e_row, i, 1), _take1(e_row, i + 1, 1)
        u0, u1 = _take1(u_row, i, 1), _take1(u_row, i + 1, 1)
        u_c = _lip(e0, u0, e1, u1, eps_target)
        # get_eps at u_c + u_seg (jr_common.h:157-177)
        u_new = u_c + u_seg[:, None].astype(dtype)
        j = _count_index(u_row, n_u, u_new, axis=1)
        uu0, uu1 = _take1(u_row, j, 1), _take1(u_row, j + 1, 1)
        ee0, ee1 = _take1(e_row, j, 1), _take1(e_row, j + 1, 1)
        eps_c = _c01(_lip(uu0, ee0, uu1, ee1, u_new))
        ok = n_u >= 2
        return eps_c, ok

    eps00, ok00 = corner(0, it0)
    eps01, ok01 = corner(0, it0 + 1)
    eps10, ok10 = corner(1, it1)
    eps11, ok11 = corner(1, it1 + 1)

    # bilinear: t within each pressure row, then p (jr_common.h:259-265)
    t00 = _take1(t_lo, it0, 1)
    t01 = _take1(t_lo, it0 + 1, 1)
    t10 = _take1(t_hi, it1, 1)
    t11 = _take1(t_hi, it1 + 1, 1)
    eps_p0 = _c01(_lip(t00, eps00, t01, eps01, tb))
    eps_p1 = _c01(_lip(t10, eps10, t11, eps11, tb))
    p0 = _take1(tbl.p, ipr, 1)
    p1 = _take1(tbl.p, ipr + 1, 1)
    eps_t = _c01(_lip(p0, eps_p0, p1, eps_p1, jnp.broadcast_to(p, (G, D))))

    # guards in reference order (jr_common.h:239-246)
    no_table = ((tbl.np_ < 2) | (nt_lo < 2) | (nt_hi < 2)
                | ~ok00 | ~ok01 | ~ok10 | ~ok11)
    tau_safe = jnp.where(tau_path < TAU_OPAQUE, 1.0, tau_path)
    factor = (1.0 - eps_t) / tau_safe
    factor = jnp.where(no_table, 1.0, factor)
    return jnp.where(tau_path < TAU_OPAQUE, 0.0, factor)


class FastDeviceTables(NamedTuple):
    """FastTables as device arrays (payloads f32)."""

    np_: jax.Array      # [G, D]
    nt: jax.Array       # [G, P, D]
    p: jax.Array        # [G, P, D]
    t: jax.Array        # [G, P, T, D]
    nu: jax.Array       # [G, P, T, D]
    log2_u0: jax.Array  # [G, P, T, D]
    eps: jax.Array      # [G, P, T, K, D]
    valid: jax.Array    # [G, P, T, D] bool


def ega_eps_fast(tbl: FastDeviceTables, tau_path, t, u_seg, p):
    """Fast-mode EGA factor on log-uniform resampled tables.

    Same contract as :func:`ega_eps_exact`.  The eps->u inversion
    (get_u, jr_common.h:180-185) is a binary search on the eps row --
    log2(K) single-element gathers instead of the exact path's O(K)
    row compare -- with u values reconstructed analytically from the
    log-uniform grid (no u payload).  The u->eps lookup (get_eps,
    jr_common.h:157-177) is pure index arithmetic: the legitimized
    FAST_INVERSE_OF_U (jurassic.c:487-609).  Interpolation stays linear
    in u with end extrapolation, identical to the reference's ``lip``.

    All four (pressure, temperature) corners are batched on one axis so
    the search runs once over [G, 4, D]; its log2(K) steps are a rolled
    ``fori_loop`` (compile-time friendly, the step count is tiny).
    """
    G, P, T, K, D = tbl.eps.shape
    dtype = tau_path.dtype

    # Flat views: single-element gathers instead of row materialization
    # (the fused kernel, ops/rt_fused.py, makes the same gathers per lane).
    eps_flat = tbl.eps.reshape(G, P * T * K, D)
    l2u0_flat = tbl.log2_u0.reshape(G, P * T, D)
    nu_flat = tbl.nu.reshape(G, P * T, D)
    valid_flat = tbl.valid.reshape(G, P * T, D)

    ipr = _count_index(tbl.p, tbl.np_, jnp.broadcast_to(p, (G, D)), axis=1)
    t_lo = _take1(tbl.t, ipr, axis=1)
    t_hi = _take1(tbl.t, ipr + 1, axis=1)
    nt_lo = _take1(tbl.nt, ipr, axis=1)
    nt_hi = _take1(tbl.nt, ipr + 1, axis=1)
    tb = jnp.broadcast_to(t, (G, D))
    it0 = _count_index(t_lo, nt_lo, tb, axis=1)
    it1 = _count_index(t_hi, nt_hi, tb, axis=1)

    eps_target = 1.0 - tau_path                  # [G, D]
    ratio = jnp.asarray(2.0 ** LOG2_RATIO_U, dtype)

    # corner axis: [(p0,t0), (p0,t0+1), (p1,t1), (p1,t1+1)] -> [G, 4, D]
    ipt = jnp.stack([ipr * T + it0, ipr * T + it0 + 1,
                     (ipr + 1) * T + it1, (ipr + 1) * T + it1 + 1], axis=1)
    l2u0 = jnp.take_along_axis(l2u0_flat, ipt, axis=1).astype(dtype)
    nk = jnp.take_along_axis(nu_flat, ipt, axis=1)
    ok = jnp.take_along_axis(valid_flat, ipt, axis=1)
    base_k = ipt * K

    def gather(i):
        return jnp.take_along_axis(eps_flat, base_k + i, axis=1).astype(dtype)

    target4 = jnp.broadcast_to(eps_target[:, None, :], ipt.shape)

    # invert: u at accumulated eps -- locate_tbl_id (jr_common.h:117-125)
    # as a rolled binary search over all corners at once
    def bs_step(_, lohi):
        lo, hi = lohi
        active = hi > lo + 1
        mid = (hi + lo) >> 1
        pred = gather(mid) > target4
        hi = jnp.where(active & pred, mid, hi)
        lo = jnp.where(active & ~pred, mid, lo)
        return lo, hi

    n_steps = max(1, int(np.ceil(np.log2(max(K, 2)))))
    lo, _ = jax.lax.fori_loop(
        0, n_steps, bs_step,
        (jnp.zeros_like(nk), jnp.maximum(nk - 1, 1)))
    e0, e1 = gather(lo), gather(lo + 1)
    u0 = jnp.exp2(l2u0 + lo.astype(dtype) * LOG2_RATIO_U)
    u1 = u0 * ratio
    u_c = _lip(e0, u0, e1, u1, target4)

    # forward: eps at u_c + u_seg; u index from log2 arithmetic
    u_new = u_c + u_seg[:, None, None].astype(dtype)
    k = (jnp.log2(jnp.maximum(u_new, 1e-300)) - l2u0) / LOG2_RATIO_U
    ki = jnp.clip(k.astype(jnp.int32), 0, jnp.maximum(nk - 2, 0))
    u_lo = jnp.exp2(l2u0 + ki.astype(dtype) * LOG2_RATIO_U)
    u_hi = u_lo * ratio
    e_lo, e_hi = gather(ki), gather(ki + 1)
    eps_c = _c01(_lip(u_lo, e_lo, u_hi, e_hi, u_new))      # [G, 4, D]

    t00 = _take1(t_lo, it0, 1).astype(dtype)
    t01 = _take1(t_lo, it0 + 1, 1).astype(dtype)
    t10 = _take1(t_hi, it1, 1).astype(dtype)
    t11 = _take1(t_hi, it1 + 1, 1).astype(dtype)
    eps_p0 = _c01(_lip(t00, eps_c[:, 0], t01, eps_c[:, 1], tb))
    eps_p1 = _c01(_lip(t10, eps_c[:, 2], t11, eps_c[:, 3], tb))
    p0 = _take1(tbl.p, ipr, 1).astype(dtype)
    p1 = _take1(tbl.p, ipr + 1, 1).astype(dtype)
    eps_t = _c01(_lip(p0, eps_p0, p1, eps_p1, jnp.broadcast_to(p, (G, D))))

    no_table = ((tbl.np_ < 2) | (nt_lo < 2) | (nt_hi < 2)
                | ~jnp.all(ok, axis=1))
    tau_safe = jnp.where(tau_path < TAU_OPAQUE, 1.0, tau_path)
    factor = (1.0 - eps_t) / tau_safe
    factor = jnp.where(no_table, 1.0, factor)
    return jnp.where(tau_path < TAU_OPAQUE, 0.0, factor)
