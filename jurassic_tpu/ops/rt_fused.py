"""Fused EGA radiative-transfer kernel for the GPU (Pallas, Triton route).

The analogue of the reference's fused CUDA kernel ``fusion_kernel_GPU``
(jr_fusion_kernel.mv4g.cu, launched block-per-ray / thread-per-channel
from GPUdrivers.cu:232): one kernel fuses the continua (continua_core,
jr_common.h:397-409), the EGA transmittance update (ega_eps +
apply_ega_core, jr_common.h:238-290), the Planck source (src_planck_core,
jr_common.h:221-224) and the radiative-transfer recursion (new_obs_core,
jr_common.h:294-300) over the whole line of sight.

Layout, after the reference:

* the grid runs over (ray block x channel block); a program holds a
  ``[block_r, block_d]`` tile of (ray, channel) lanes, and the channel
  tail of the last block is masked at the store;
* the LOS loop is a ``fori_loop`` inside the kernel, bounded by the
  block's longest ray, with ``rad`` and ``tau`` in registers; the per-gas
  ``tau_path`` (the reference's ``tau_path[NG]``) sits in a per-lane
  scratch that only its own lane touches, so it stays in L1 and the gas
  loop stays rolled -- unrolled, Triton's compile time grows with the
  gas count past minutes at NG = 30;
* the continuum flags are static, like the reference's 16 compiled
  specialisations (jr_multiversion4gases.h);
* table reads are gathers from the channel-minor
  :class:`~jurassic_tpu.ops.ega.FastDeviceTables` arrays: for one table
  row, consecutive channels are consecutive addresses, so a warp's reads
  coalesce and repeated rows hit L1/L2 like the reference's ``__ldg``
  reads.

Where the table axes are channel-uniform (tables generated on one grid),
the per-(ray, segment, gas) (p, T) bracketing does not depend on the
channel.  It then runs once per segment in XLA before the kernel
(:func:`segment_streams`) instead of once per lane; ragged tables keep
the jnp path.  The lane arithmetic follows
:func:`~jurassic_tpu.ops.ega.ega_eps_fast` operation by operation, in
float32 like the reference's GPU payloads (jurassic.h:387).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from ..constants import NA, P0, TAU_CUTOFF, TAU_OPAQUE
from ..tables import LOG2_RATIO_U, FastTables
from .ega import FastDeviceTables

N_CC = 12    # continuum coefficient rows of pack_continua
N_SEG = 7    # fixed segment fields: valid p t ds q_h2o u_co2 u_h2o
N_AX = 6     # per-gas bracketing values: t00 t01 t10 t11 p0 p1
N_IDX = 5    # per-gas ints: four corner cells and the axis-guard flag


class KernelAxes(NamedTuple):
    """Channel-uniform table axes per gas (device arrays)."""

    p: jax.Array      # [G, P] pressure axis
    t: jax.Array      # [G, P, T] temperature axis per pressure level
    np_: jax.Array    # [G] int32 pressure-level count
    nt: jax.Array     # [G, P] int32 temperature count per level


def kernel_axes(ft: FastTables) -> KernelAxes | None:
    """The per-gas (p, T) axes shared by every channel that has a table,
    or None when they differ between channels (ragged tables)."""
    G, P, T, _, _ = ft.eps.shape
    p_ax = np.zeros((G, P))
    t_ax = np.zeros((G, P, T))
    np_u = np.zeros(G, np.int32)
    nt_u = np.zeros((G, P), np.int32)
    for g in range(G):
        chans = np.nonzero(ft.np_[g] >= 2)[0]
        if chans.size == 0:
            continue
        d0 = chans[0]
        np_u[g] = ft.np_[g, d0]
        nt_u[g] = ft.nt[g, :, d0]
        p_ax[g] = ft.p[g, :, d0]
        t_ax[g] = ft.t[g, :, :, d0]
        for d in chans[1:]:
            if (ft.np_[g, d] != np_u[g]
                    or not np.array_equal(ft.nt[g, :, d], nt_u[g])
                    or not np.allclose(ft.p[g, :, d], p_ax[g])
                    or not np.allclose(ft.t[g, :, :, d], t_ax[g])):
                return None
    return KernelAxes(p=jnp.asarray(p_ax), t=jnp.asarray(t_ax),
                      np_=jnp.asarray(np_u), nt=jnp.asarray(nt_u))


def pack_continua(cc, window, nd: int, nw: int) -> jax.Array:
    """Continuum coefficients as [N_CC + W, D] float32 rows with the band
    masks applied (continua_ctm*, jr_common.h:316-390), followed by one
    one-hot row per declared window (``nw`` = ctl.nw) for the gray
    extinction's channel -> window map."""
    m = np.zeros((N_CC, nd))
    z = lambda a: np.asarray(a, np.float64)
    m[0] = np.where(cc.co2_mask, z(cc.co2_cw296), 0)
    m[1] = np.where(cc.co2_mask, z(cc.co2_cw260), 0)
    m[2] = np.where(cc.co2_mask, z(cc.co2_cw230), 0)
    m[3] = np.where(cc.h2o_mask, z(cc.h2o_cw296), 0)
    m[4] = np.where(cc.h2o_mask, z(cc.h2o_cw260), 0)
    m[5] = np.where(cc.h2o_mask, z(cc.h2o_ctwfrn), 0)
    m[6] = np.where(cc.h2o_mask, z(cc.h2o_sfac), 0)
    m[7] = np.where(cc.h2o_mask, z(cc.h2o_nu), 0)
    m[8] = np.where(cc.n2_mask, z(cc.n2_b), 0)
    m[9] = np.where(cc.n2_mask, z(cc.n2_beta), 0)
    m[10] = np.where(cc.o2_mask, z(cc.o2_b), 0)
    m[11] = np.where(cc.o2_mask, z(cc.o2_beta), 0)
    W = max(int(np.max(window)) + 1 if len(window) else 1, nw, 1)
    oh = np.zeros((W, nd))
    oh[np.asarray(window, int), np.arange(nd)] = 1.0
    return jnp.asarray(np.concatenate([m, oh], 0), jnp.float32)


# ---------------------------------------------------------------------------
# Prologue (XLA): per-(ray, segment) scalar streams

def _count_last(values, counts, x):
    """#{values <= x within count} - 1, clipped to [0, count - 2], over
    the last axis (locate_id / locate_tbl_id, jr_common.h:107-125)."""
    iota = jax.lax.broadcasted_iota(jnp.int32, values.shape, values.ndim - 1)
    below = (values <= x[..., None]) & (iota < counts[..., None])
    idx = jnp.sum(below.astype(jnp.int32), axis=-1) - 1
    return jnp.clip(idx, 0, jnp.maximum(counts - 2, 0))


def _pick_last(values, idx):
    """values[..., idx] with idx clipped into range (``_take1``)."""
    n = values.shape[-1]
    return jnp.take_along_axis(values, jnp.clip(idx, 0, n - 1)[..., None],
                               axis=-1)[..., 0]


def segment_streams(ax: KernelAxes, los, ig_co2: int, ig_h2o: int):
    """The kernel's per-(ray, segment) inputs, as two row-major streams.

    ``seg`` [R*S, N_SEG + W + G + N_AX*G] float32: valid, p, t, ds,
    q_h2o, u_co2, u_h2o, the gray extinction per window, the column
    density per gas, then per gas the bracketing axis values
    (t00, t01, t10, t11, p0, p1).  ``idx`` [R*S, N_IDX*G] int32: per gas
    the four corner cells (flat p*T + t indices of (p0,t0), (p0,t0+1),
    (p1,t1), (p1,t1+1)) and the axis guard (np_ >= 2 & nt_lo >= 2 &
    nt_hi >= 2, jr_common.h:239-246).  The bracketing is the one of
    :func:`~jurassic_tpu.ops.ega.ega_eps_fast` (gathers, no contraction:
    a float32 matrix product could run in TF32 on the GPU)."""
    R, S = los.ds.shape
    G, P, T = ax.t.shape
    dt = los.p.dtype
    p, t = los.p, los.t
    pg = jnp.broadcast_to(p[..., None], (R, S, G))
    tg = jnp.broadcast_to(t[..., None], (R, S, G))
    ipr = _count_last(jnp.broadcast_to(ax.p, (R, S, G, P)),
                      jnp.broadcast_to(ax.np_, (R, S, G)), pg)
    ipr1 = jnp.minimum(ipr + 1, P - 1)
    gi = jnp.arange(G)
    t_lo, t_hi = ax.t[gi, ipr], ax.t[gi, ipr1]                # [R,S,G,T]
    nt_lo, nt_hi = ax.nt[gi, ipr], ax.nt[gi, ipr1]            # [R,S,G]
    it0 = _count_last(t_lo, nt_lo, tg)
    it1 = _count_last(t_hi, nt_hi, tg)
    vals = jnp.stack([_pick_last(t_lo, it0), _pick_last(t_lo, it0 + 1),
                      _pick_last(t_hi, it1), _pick_last(t_hi, it1 + 1),
                      ax.p[gi, ipr], ax.p[gi, ipr1]], axis=-1)
    last = P * T - 1
    cells = jnp.stack([ipr * T + it0, ipr * T + it0 + 1,
                       (ipr + 1) * T + it1, (ipr + 1) * T + it1 + 1],
                      axis=-1)
    guard = ((ax.np_ >= 2) & (nt_lo >= 2) & (nt_hi >= 2)).astype(jnp.int32)
    idx = jnp.concatenate([jnp.clip(cells, 0, last), guard[..., None]],
                          axis=-1)
    z = jnp.zeros((R, S), dt)
    cols = jnp.stack([los.valid.astype(dt), p, t, los.ds,
                      los.q[:, :, ig_h2o] if ig_h2o >= 0 else z,
                      los.u[:, :, ig_co2] if ig_co2 >= 0 else z,
                      los.u[:, :, ig_h2o] if ig_h2o >= 0 else z], axis=-1)
    seg = jnp.concatenate([cols, los.k.astype(dt), los.u,
                           vals.astype(dt).reshape(R, S, G * N_AX)],
                          axis=-1).astype(jnp.float32)
    return (seg.reshape(R * S, seg.shape[-1]),
            idx.astype(jnp.int32).reshape(R * S, G * N_IDX))


# ---------------------------------------------------------------------------
# The kernel

def _lip(x0, y0, x1, y1, x):
    """lip with a guarded denominator (jr_common.h:48-50)."""
    d = x1 - x0
    d = jnp.where(d == 0, np.float32(1.0), d)
    return y0 + (x - x0) * (y1 - y0) / d


def _c01(x):
    return jnp.clip(x, np.float32(0.0), np.float32(1.0))


def continua_bds(p, t, ds, q_h2o, u_co2, u_h2o, kw, cc, flags):
    """Continuum optical depth of one segment (continua_core,
    jr_common.h:397-409): gray extinction ``kw`` times ``ds`` plus the
    enabled continua; ``cc`` are the pack_continua rows."""
    f_co2, f_h2o, f_n2, f_o2 = flags
    bds = kw * ds
    if f_co2:
        dt230, dt260, dt296 = t - 230.0, t - 260.0, t - 296.0
        ctw = (dt260 * 5.050505e-4 * dt296 * cc[2]
               - dt230 * 9.259259e-4 * dt296 * cc[1]
               + dt230 * 4.208754e-4 * dt260 * cc[0])
        bds = bds + u_co2 * p * ctw / np.float32(NA * 1000.0 * P0)
    if f_h2o:
        cw296, cw260 = cc[3], cc[4]
        base = jnp.where(cw296 > 0,
                         cw260 / jnp.where(cw296 > 0, cw296, 1.0), 1.0)
        ctwslf = cc[6] * cw296 * jnp.power(base, (296.0 - t) / 36.0)
        a1 = cc[7] * u_h2o * jnp.tanh(0.7193876 / t * cc[7])
        a3 = (p / np.float32(P0) * (q_h2o * ctwslf + (1 - q_h2o) * cc[5])
              * np.float32(1e-20))
        bds = bds + a1 * (296.0 / t) * a3
    if f_n2 or f_o2:
        pp2 = (p / np.float32(P0)) ** 2 * (273.0 / t) ** 2
        tfac = 1.0 / 296.0 - 1.0 / t
        if f_n2:
            mix = 0.79 + 0.21 * (1.294 - 0.4545 * t / 296.0)
            bds = bds + (0.1 * pp2 * jnp.exp(cc[9] * tfac) * 0.79 * cc[8]
                         * mix) * ds
        if f_o2:
            bds = bds + (0.1 * pp2 * jnp.exp(cc[11] * tfac) * 0.21
                         * cc[10]) * ds
    return bds


def _make_kernel(*, G, W, S, K, PT, NS, D, flags, block_r, block_d):
    """Kernel body with every shape and configuration static."""
    f32, i32 = jnp.float32, jnp.int32
    R6 = np.float32(LOG2_RATIO_U)
    RATIO = np.float32(2.0 ** LOG2_RATIO_U)
    TINY = np.float32(np.finfo(np.float32).tiny)
    n_search = max(1, int(np.ceil(np.log2(max(K, 2)))))
    F_U = N_SEG + W          # first column density field
    F_AX = F_U + G           # first bracketing value field
    shape = (block_r, block_d)

    def kernel(nlos_ref, seg_ref, idx_ref, eps_ref, l2u0_ref, nk_ref,
               valid_ref, chan_ref, cc_ref, sr_ref, st_ref,
               rad_ref, tau_ref, tp_ref):
        full = lambda x: jnp.broadcast_to(x, shape)
        const = lambda i: jnp.full(shape, i, i32)
        rows = pl.program_id(0) * block_r + jnp.arange(block_r, dtype=i32)
        r = full(rows[:, None])
        d = full(pl.program_id(1) * block_d
                 + jnp.arange(block_d, dtype=i32)[None, :])
        live = d < D
        dc = jnp.minimum(d, D - 1)       # tail lanes read channel D-1
        cc = [cc_ref[const(i), dc] for i in range(N_CC + W)]
        n_seg = jnp.max(nlos_ref[rows])
        one = jnp.ones(shape, f32)

        def corner(g, cell, target, u_g):
            """One (p, T) corner: eps -> u inversion by binary search on
            the eps row, add the segment's u, eps at the new u by index
            arithmetic (ega_eps_fast)."""
            crow = cell + g * PT
            l2u0 = l2u0_ref[crow, dc]
            nk = nk_ref[crow, dc]
            ok = valid_ref[crow, dc]
            erow = crow * K

            def eps_at(k):
                return eps_ref[erow + jnp.minimum(k, K - 1), dc]

            lo = jnp.zeros(shape, i32)
            hi = jnp.maximum(nk - 1, 1)
            for _ in range(n_search):
                active = hi > lo + 1
                mid = (hi + lo) >> 1
                pred = eps_at(mid) > target
                hi = jnp.where(active & pred, mid, hi)
                lo = jnp.where(active & ~pred, mid, lo)
            u0 = jnp.exp2(l2u0 + lo.astype(f32) * R6)
            u_c = _lip(eps_at(lo), u0, eps_at(lo + 1), u0 * RATIO, target)
            u_new = u_c + u_g
            kf = (jnp.log2(jnp.maximum(u_new, TINY)) - l2u0) / R6
            ki = jnp.clip(kf, 0.0, np.float32(K)).astype(i32)
            ki = jnp.minimum(ki, jnp.maximum(nk - 2, 0))
            u_lo = jnp.exp2(l2u0 + ki.astype(f32) * R6)
            eps_c = _c01(_lip(u_lo, eps_at(ki), u_lo * RATIO,
                              eps_at(ki + 1), u_new))
            return eps_c, ok

        # tau_path [G] per lane lives in the tp_ref scratch: each lane
        # reads back only what it wrote, so it stays in L1 and the gas
        # loop can stay rolled (one copy of the gas body to compile)
        def init_gas(g, c):
            pltr.store(tp_ref.at[r, full(g), d], one, mask=live)
            return c

        jax.lax.fori_loop(0, G, init_gas, 0)

        def body(s, carry):
            rad, tau = carry
            row = r * S + s
            fld = lambda i: seg_ref[row, const(i)]
            valid = fld(0) > 0.5
            p, t, ds = fld(1), fld(2), fld(3)
            kw = cc[N_CC] * fld(N_SEG)
            for w in range(1, W):
                kw = kw + cc[N_CC + w] * fld(N_SEG + w)
            bds = continua_bds(p, t, ds, fld(4), fld(5), fld(6), kw, cc,
                               flags)

            def gas(g, tau_gas):
                tp = tp_ref[r, full(g), dc]
                u_g = fld(F_U + g)
                ax = lambda j: fld(F_AX + N_AX * g + j)
                cells = [idx_ref[row, const(N_IDX * g + c)]
                         for c in range(N_IDX)]
                target = 1.0 - tp
                has_table = (chan_ref[full(g), dc] >= 2) & (cells[4] > 0)
                eps_c = []
                for c in range(4):
                    e, ok = corner(g, cells[c], target, u_g)
                    eps_c.append(e)
                    has_table = has_table & ok
                eps_p0 = _c01(_lip(ax(0), eps_c[0], ax(1), eps_c[1], t))
                eps_p1 = _c01(_lip(ax(2), eps_c[2], ax(3), eps_c[3], t))
                eps_t = _c01(_lip(ax(4), eps_p0, ax(5), eps_p1, p))
                opaque = tp < TAU_OPAQUE
                factor = (1.0 - eps_t) / jnp.where(opaque, 1.0, tp)
                factor = jnp.where(has_table, factor, 1.0)
                factor = jnp.where(opaque, 0.0, factor)
                pltr.store(tp_ref.at[r, full(g), d],
                           jnp.where(valid, tp * factor, tp), mask=live)
                return tau_gas * factor

            tau_gas = jax.lax.fori_loop(0, G, gas, one)
            # source (src_planck_core; locate_st, jr_common.h:83-84)
            it = jnp.clip((4.0 * t).astype(i32) - 400, 0, NS - 2)
            st0, st1 = st_ref[it], st_ref[it + 1]
            sr0, sr1 = sr_ref[it, dc], sr_ref[it + 1, dc]
            src = sr0 + (t - st0) * (sr1 - sr0) / (st1 - st0)
            # integration (new_obs_core, jr_common.h:294-300)
            eps = 1.0 - tau_gas * jnp.exp(-bds)
            upd = valid & (tau_gas > TAU_CUTOFF)
            rad = jnp.where(upd, rad + src * eps * tau, rad)
            tau = jnp.where(upd, tau * (1.0 - eps), tau)
            return rad, tau

        rad, tau = jax.lax.fori_loop(0, n_seg, body,
                                     (jnp.zeros(shape, f32), one))
        pltr.store(rad_ref.at[r, d], rad, mask=live)
        pltr.store(tau_ref.at[r, d], tau, mask=live)

    return kernel


def default_blocks(nd: int, interpret: bool = False) -> tuple[int, int, int]:
    """(block_r, block_d, num_warps): one ray per program and up to 128
    channels, one channel per thread -- the reference's block-per-ray,
    thread-per-channel launch (GPUdrivers.cu:232).  The interpreter runs
    programs one after another, so it takes 8 rays per program."""
    block_d = int(min(128, max(16, pl.next_power_of_2(max(nd, 1)))))
    return 8 if interpret else 1, block_d, max(1, block_d // 32)


def rt_fused(tbl: FastDeviceTables, ax: KernelAxes, cc_rows, sr, st, los,
             *, flags, ig_co2: int, ig_h2o: int, interpret: bool = False,
             blocks: tuple[int, int, int] | None = None):
    """Run the fused kernel over traced lines of sight.

    Returns ``(rad, tau)`` [R, D] float32 before the surface and
    brightness epilogues.  ``interpret`` runs the kernel in Pallas
    interpret mode (CPU tests); ``blocks`` overrides
    :func:`default_blocks`.  Unjitted: the callers jit it (also the
    per-shard body of the multi-device driver)."""
    G, P, T, K, D = tbl.eps.shape
    R, S = los.ds.shape
    W = los.k.shape[2]
    block_r, block_d, num_warps = blocks or default_blocks(D, interpret)
    Rp = -(-R // block_r) * block_r
    if Rp != R:
        # repeat the last ray: padded rows are well-posed and discarded
        los = jax.tree_util.tree_map(
            lambda a: jnp.pad(a, [(0, Rp - R)] + [(0, 0)] * (a.ndim - 1),
                              mode="edge"), los)
    seg, idx = segment_streams(ax, los, ig_co2, ig_h2o)
    f32 = jnp.float32
    NS = sr.shape[0]
    kernel = _make_kernel(G=G, W=W, S=S, K=K, PT=P * T, NS=NS, D=D,
                          flags=tuple(bool(f) for f in flags),
                          block_r=block_r, block_d=block_d)
    out = jax.ShapeDtypeStruct((Rp, D), f32)
    scratch = jax.ShapeDtypeStruct((Rp, G, D), f32)
    rad, tau, _ = pl.pallas_call(
        kernel, out_shape=(out, out, scratch),
        grid=(Rp // block_r, pl.cdiv(D, block_d)),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=num_warps,
                                            num_stages=1),
        interpret=interpret, name="ega_rt_fused",
    )(los.np_.astype(jnp.int32), seg, idx,
      tbl.eps.reshape(G * P * T * K, D).astype(f32),
      tbl.log2_u0.reshape(G * P * T, D).astype(f32),
      tbl.nu.reshape(G * P * T, D).astype(jnp.int32),
      tbl.valid.reshape(G * P * T, D),
      tbl.np_.astype(jnp.int32), cc_rows.astype(f32),
      sr.astype(f32), st.astype(f32))
    return rad[:R], tau[:R]
