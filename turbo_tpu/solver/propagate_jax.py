"""Batched AC-1 interval propagation in JAX (XLA) for the device engine.

The hot kernel of the framework: the equivalent of the reference's
``fp_engine.fixpoint([&](int i){ iprop.deduce(i); })`` inner loop
(barebones_dive_and_solve.hpp:927-965), vectorized over
(dives x propagators) instead of (threads x propagators).

Design (gather-only, no scatters):
  1. per op-group, gather x/y/z bounds and compute candidate intervals
     for all three roles of every propagator (elementwise work);
  2. combine candidates into variables via the plan's bucketed
     incidence tables: contiguous var ranges gather their candidate
     slots and min/max-reduce, in place of the reference's atomic
     scatter-min/max;
  3. loop to fixpoint with a per-dive changed mask inside
     ``lax.while_loop``.

Deduction rules mirror `turbo_tpu.solver.deduce_np` (the numpy oracle);
tests cross-check both on random stores.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.ops import INF, NINF, OP_ADD, OP_DIV, OP_EQ, OP_LE, OP_MAX, OP_MIN, OP_MUL
from .plan import Plan

I32 = jnp.int32
I64 = jnp.int64


def _tdiv(a, b):
    q = jnp.floor_divide(a, b)
    r = a - q * b
    return q + ((r != 0) & ((a < 0) != (b < 0)))


def _clamp32(lo, hi):
    lo = jnp.clip(lo, NINF, INF).astype(I32)
    hi = jnp.clip(hi, NINF, INF).astype(I32)
    return lo, hi


def _deduce_group(op, lx, ux, ly, uy, lz, uz):
    """JAX mirror of deduce_np.deduce for one op-group.

    Inputs are int32 (D, n). MUL/DIV groups compute wide in int64.
    Returns 6 int32 arrays (cxl, cxu, cyl, cyu, czl, czu).
    """
    ninf = jnp.full_like(lx, NINF)
    pinf = jnp.full_like(lx, INF)
    if op == OP_ADD:
        cxl, cxu = ly + lz, uy + uz  # operands in [-INF, INF]: no overflow
        cyl, cyu = lx - uz, ux - lz
        czl, czu = lx - uy, ux - ly
    elif op == OP_MUL:
        ly64, uy64, lz64, uz64 = (v.astype(I64) for v in (ly, uy, lz, uz))
        lx64, ux64 = lx.astype(I64), ux.astype(I64)
        p1, p2, p3, p4 = ly64 * lz64, ly64 * uz64, uy64 * lz64, uy64 * uz64
        cxl = jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4))
        cxu = jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4))
        cyl, cyu = _inv_mul(lx64, ux64, lz64, uz64)
        czl, czu = _inv_mul(lx64, ux64, ly64, uy64)
    elif op == OP_DIV:
        ly64, uy64, lz64, uz64 = (v.astype(I64) for v in (ly, uy, lz, uz))
        lx64, ux64 = lx.astype(I64), ux.astype(I64)
        cxl, cxu = _fwd_div(ly64, uy64, lz64, uz64)
        mz = jnp.maximum(jnp.abs(lz64), jnp.abs(uz64))
        p1, p2, p3, p4 = lx64 * lz64, lx64 * uz64, ux64 * lz64, ux64 * uz64
        pad = jnp.maximum(mz - 1, 0)
        cyl = jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4)) - pad
        cyu = jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4)) + pad
        czl, czu = ninf.astype(I64), pinf.astype(I64)
        zzero = (lz == 0) & (uz == 0)
        cxl = jnp.where(zzero, INF, cxl)
        cxu = jnp.where(zzero, NINF, cxu)
    elif op == OP_MIN:
        cxl = jnp.minimum(ly, lz)
        cxu = jnp.minimum(uy, uz)
        cyl = lx
        cyu = jnp.where(lz > ux, ux, pinf)
        czl = lx
        czu = jnp.where(ly > ux, ux, pinf)
    elif op == OP_MAX:
        cxl = jnp.maximum(ly, lz)
        cxu = jnp.maximum(uy, uz)
        cyu = ux
        cyl = jnp.where(uz < lx, lx, ninf)
        czu = ux
        czl = jnp.where(uy < lx, lx, ninf)
    elif op == OP_LE:
        cxl = (uy <= lz).astype(I32)
        cxu = 1 - (ly > uz).astype(I32)
        tt = lx >= 1
        ff = ux <= 0
        cyl = jnp.where(ff, lz + 1, ninf)
        cyu = jnp.where(tt, uz, pinf)
        czl = jnp.where(tt, ly, ninf)
        czu = jnp.where(ff, uy - 1, pinf)
    elif op == OP_EQ:
        cxl = ((ly == uy) & (uy == lz) & (lz == uz)).astype(I32)
        cxu = (jnp.maximum(ly, lz) <= jnp.minimum(uy, uz)).astype(I32)
        tt = lx >= 1
        ff = ux <= 0
        zsing = lz == uz
        ysing = ly == uy
        cyl = jnp.where(tt, lz, jnp.where(ff & zsing & (lz == ly), ly + 1, ninf))
        cyu = jnp.where(tt, uz, jnp.where(ff & zsing & (lz == uy), uy - 1, pinf))
        czl = jnp.where(tt, ly, jnp.where(ff & ysing & (ly == lz), lz + 1, ninf))
        czu = jnp.where(tt, uy, jnp.where(ff & ysing & (ly == uz), uz - 1, pinf))
    else:
        raise ValueError(op)
    cxl, cxu = _clamp32(cxl, cxu)
    cyl, cyu = _clamp32(cyl, cyu)
    czl, czu = _clamp32(czl, czu)
    return cxl, cxu, cyl, cyu, czl, czu


def _inv_mul(la, ua, lb, ub):
    has0 = (lb <= 0) & (ub >= 0)
    sb = jnp.where(lb == 0, 1, lb)
    tb = jnp.where(ub == 0, -1, ub)
    los, his = [], []
    for a in (la, ua):
        for b in (sb, tb):
            los.append(-jnp.floor_divide(-a, b))  # ceil
            his.append(jnp.floor_divide(a, b))    # floor
    lo = functools.reduce(jnp.minimum, los)
    hi = functools.reduce(jnp.maximum, his)
    return jnp.where(has0, NINF, lo), jnp.where(has0, INF, hi)


def _fwd_div(ly, uy, lz, uz):
    lo = jnp.full_like(ly, INF)
    hi = jnp.full_like(ly, NINF)
    for plo, phi, valid in (
        (lz, jnp.minimum(uz, -1), lz <= -1),
        (jnp.maximum(lz, 1), uz, uz >= 1),
    ):
        plo_s = jnp.where(valid, plo, 1)
        phi_s = jnp.where(valid, phi, 1)
        for a in (ly, uy):
            for zc in (plo_s, phi_s):
                q = _tdiv(a, zc)
                lo = jnp.where(valid, jnp.minimum(lo, q), lo)
                hi = jnp.where(valid, jnp.maximum(hi, q), hi)
    return lo, hi


def _ask_group(op, lx, ux, ly, uy, lz, uz):
    sing = (lx == ux) & (ly == uy) & (lz == uz)
    if op == OP_ADD:
        return sing & (lx == ly + lz)
    if op == OP_MUL:
        return sing & (lx.astype(I64) == ly.astype(I64) * lz.astype(I64))
    if op == OP_DIV:
        return sing & (lz != 0) & (lx == _tdiv(ly, jnp.where(lz == 0, 1, lz)))
    if op == OP_MIN:
        return sing & (lx == jnp.minimum(ly, lz))
    if op == OP_MAX:
        return sing & (lx == jnp.maximum(ly, lz))
    if op == OP_LE:
        return ((lx >= 1) & (uy <= lz)) | ((ux <= 0) & (ly > uz))
    if op == OP_EQ:
        return ((lx >= 1) & (ly == uy) & (lz == uz) & (ly == lz)) | \
               ((ux <= 0) & ((uy < lz) | (ly > uz)))
    raise ValueError(op)


class PropagatorKernels:
    """Compiled-in static tables + jit-compatible propagation functions."""

    def __init__(self, plan: Plan):
        self.plan = plan
        self.groups = [(op, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(zs))
                       for op, xs, ys, zs in plan.groups]
        self.buckets = [(b.start, b.count, jnp.asarray(b.cand_idx))
                        for b in plan.buckets]
        # Singleton-tail conflict fold (see Plan.conf_idx): deductions
        # into root-fixed vars outside the bucketed combine collapse to
        # a bot signal in the dummy column.
        self.conf_idx = (jnp.asarray(plan.conf_idx)
                         if plan.conf_idx is not None else None)
        self.conf_off = (jnp.asarray(plan.conf_off)
                         if plan.conf_idx is not None else None)
        self.n_active = plan.n_active
        self.V = plan.V
        self.P = plan.P
        # Concatenated operand indices (group order): one gather per
        # role per bound instead of one per (group, role).
        if plan.groups:
            self.all_x = jnp.asarray(np.concatenate([g[1] for g in plan.groups]))
            self.all_y = jnp.asarray(np.concatenate([g[2] for g in plan.groups]))
            self.all_z = jnp.asarray(np.concatenate([g[3] for g in plan.groups]))
        self.group_slices = []
        base = 0
        for op, xs, _, _ in plan.groups:
            self.group_slices.append((op, base, base + len(xs)))
            base += len(xs)
        # Native element / membership tables (see plan.py).
        self.E = plan.E
        self.M = plan.M
        if self.E:
            self.e_idx = jnp.asarray(plan.e_idx)
            self.e_res = jnp.asarray(plan.e_res)
            self.e_len = jnp.asarray(plan.e_len)
            self.e_tab = jnp.asarray(plan.e_tab)
        self.lin_buckets = [tuple(jnp.asarray(a) for a in bk)
                            for bk in plan.lin_buckets]
        # Static per-bucket flag: all coefficients in {-1, 0, +1}.
        # For unit coefficients floor(R/c) == ceil(R/c) == R*c, so the
        # int64 floor_divide + remainder-correction chains collapse to
        # one multiply.
        self.lin_unit = [bool(np.all(np.abs(bk[3]) <= 1))
                         for bk in plan.lin_buckets]
        # Root-box store clamp (see _clamp_store): with every store
        # plane bounded by the root box +/-1, per-bucket *static* sum
        # bounds can prove the whole linear kernel fits int32, which
        # skips the int64 mul/div/sum chains.
        self._lb_floor = jnp.asarray(plan.lb0) - 1   # ub clamp floor
        self._ub_cap = jnp.asarray(plan.ub0) + 1     # lb clamp ceiling
        vmax = np.maximum(np.abs(plan.lb0.astype(np.int64)),
                          np.abs(plan.ub0.astype(np.int64))) + 1
        self.lin_fit32 = []
        for bi, (l_b, l_op, l_rhs, l_coef, l_var) in \
                enumerate(plan.lin_buckets):
            tb = np.abs(l_coef.astype(np.int64)) * vmax[l_var]  # (C, K)
            s_bound = tb.sum(axis=1)
            r_bound = np.abs(l_rhs.astype(np.int64)) + 1 + s_bound + \
                tb.max(axis=1, initial=0)
            # All-zero-coefficient padding rows carry a 2^40 sentinel
            # rhs; they contribute nothing (term candidates are masked
            # by `live`) and their entailment comparisons give the same
            # answers against any rhs >= 1, so clamp the sentinel into
            # int32 range and judge the fit on real rows only.
            live_row = (l_coef != 0).any(axis=1)
            fit = bool((r_bound[live_row] < (1 << 30)).all())
            self.lin_fit32.append(fit)
            if fit:
                rhs32 = np.clip(l_rhs, -(1 << 30), 1 << 30).astype(np.int32)
                self.lin_buckets[bi] = (
                    jnp.asarray(l_b), jnp.asarray(l_op), jnp.asarray(rhs32),
                    jnp.asarray(l_coef.astype(np.int32)), jnp.asarray(l_var))
        if self.M:
            self.m_x = jnp.asarray(plan.m_x)
            self.m_b = jnp.asarray(plan.m_b)
            self.m_base = jnp.asarray(plan.m_base)
            self.m_top = jnp.asarray(plan.m_top)
            # Row tables flattened for single-gather row lookups: a
            # (D, M) index into the flat (M*W) table replaces a
            # (D, M, W) broadcast + take_along_axis.
            M_ = plan.m_cnt.shape[0]
            self.m_W = plan.m_cnt.shape[1] - 1
            self.m_cnt_flat = jnp.asarray(plan.m_cnt.reshape(-1))
            self.m_cnt_offs = jnp.asarray(
                (np.arange(M_) * (self.m_W + 1)).astype(np.int32))
            self.m_offs = jnp.asarray(
                (np.arange(M_) * self.m_W).astype(np.int32))
            self.m_next_ge = jnp.asarray(plan.m_next_ge.reshape(-1))
            self.m_prev_le = jnp.asarray(plan.m_prev_le.reshape(-1))
            self.m_next_out = jnp.asarray(plan.m_next_out.reshape(-1))
            self.m_prev_out = jnp.asarray(plan.m_prev_out.reshape(-1))

    SUM_CLAMP = 1 << 40

    def _role_gathers(self, lb, ub, transposed: bool = False):
        """The six per-sweep role gathers (lb/ub x operand role)."""
        if transposed:
            return (lb[self.all_x], ub[self.all_x], lb[self.all_y],
                    ub[self.all_y], lb[self.all_z], ub[self.all_z])
        return (lb[:, self.all_x], ub[:, self.all_x], lb[:, self.all_y],
                ub[:, self.all_y], lb[:, self.all_z], ub[:, self.all_z])

    def _linear_bucket_cands(self, lb, ub, lbk, unit=False, fit32=False):
        """Candidates for one linear bucket: returns (term_lo, term_hi
        (D, C*K) flattened, b_lo, b_hi (D, C)). `unit` (static): all
        coefficients are 0/±1, enabling the division-free path.
        `fit32` (static): the root-box bound proves every term sum and
        slack fits int32 (see __init__), so the whole bucket runs in
        native 32-bit arithmetic with no saturating clamp."""
        l_b, l_op, l_rhs, l_coef, l_var = lbk
        DT = I32 if fit32 else I64
        D = lb.shape[0]
        C, K = l_coef.shape
        xl = lb[:, l_var.reshape(-1)].reshape(D, C, K).astype(DT)
        xu = ub[:, l_var.reshape(-1)].reshape(D, C, K).astype(DT)
        c = l_coef.astype(DT)[None, :, :]
        a = c * xl
        b2 = c * xu
        if fit32:
            tmin = jnp.minimum(a, b2)
            tmax = jnp.maximum(a, b2)
        else:
            tmin = jnp.clip(jnp.minimum(a, b2), -self.SUM_CLAMP,
                            self.SUM_CLAMP)
            tmax = jnp.clip(jnp.maximum(a, b2), -self.SUM_CLAMP,
                            self.SUM_CLAMP)
        Smin = tmin.sum(axis=2)
        Smax = tmax.sum(axis=2)
        rhs = l_rhs.astype(DT)[None, :]
        is_eq = (l_op == 1)[None, :]
        b_lo = jnp.where(is_eq, (Smin == rhs) & (Smax == rhs),
                         Smax <= rhs).astype(I32)
        b_hi = jnp.where(is_eq, (Smin <= rhs) & (rhs <= Smax),
                         Smin <= rhs).astype(I32)
        tt = (lb[:, l_b] >= 1)[:, :, None]
        ff = (ub[:, l_b] <= 0)[:, :, None]
        live = (l_coef != 0)[None, :, :]
        csafe = jnp.where(live, c, 1)
        # "<=" direction: one division; ceil derived from floor+rem.
        R = rhs[:, :, None] - (Smin[:, :, None] - tmin)
        # ">=" direction.
        rhs2 = jnp.where(is_eq, rhs, rhs + 1)[:, :, None]
        R2 = rhs2 - (Smax[:, :, None] - tmax)
        if unit:
            # c in {-1, +1} (dead slots masked below): R/c == R*c exact.
            q_le = ceil_le = R * csafe
            q_ge = ceil_ge = R2 * csafe
        else:
            q_le = jnp.floor_divide(R, csafe)
            ceil_le = q_le + ((R - q_le * csafe) != 0)
            q_ge = jnp.floor_divide(R2, csafe)
            ceil_ge = q_ge + ((R2 - q_ge * csafe) != 0)
        cpos = (l_coef > 0)[None, :, :]
        is_eq3 = is_eq[:, :, None]
        ge_act = (is_eq3 & tt) | (~is_eq3 & ff)
        le_act = tt
        term_hi = jnp.where(live & le_act & cpos, q_le, INF)
        term_hi = jnp.minimum(term_hi,
                              jnp.where(live & ge_act & ~cpos, q_ge, INF))
        term_lo = jnp.where(live & le_act & ~cpos, ceil_le, NINF)
        term_lo = jnp.maximum(term_lo,
                              jnp.where(live & ge_act & cpos, ceil_ge, NINF))
        term_lo = jnp.clip(term_lo, NINF, INF).astype(I32).reshape(D, C * K)
        term_hi = jnp.clip(term_hi, NINF, INF).astype(I32).reshape(D, C * K)
        return term_lo, term_hi, b_lo, b_hi

    def _linear_ask_all(self, lb, ub):
        out = jnp.ones(lb.shape[0], dtype=bool)
        for lbk, fit32 in zip(self.lin_buckets, self.lin_fit32):
            l_b, l_op, l_rhs, l_coef, l_var = lbk
            DT = I32 if fit32 else I64
            D = lb.shape[0]
            C, K = l_coef.shape
            xl = lb[:, l_var.reshape(-1)].reshape(D, C, K).astype(DT)
            xu = ub[:, l_var.reshape(-1)].reshape(D, C, K).astype(DT)
            c = l_coef.astype(DT)[None, :, :]
            a = c * xl
            b2 = c * xu
            if fit32:
                Smin = jnp.minimum(a, b2).sum(axis=2)
                Smax = jnp.maximum(a, b2).sum(axis=2)
            else:
                Smin = jnp.clip(jnp.minimum(a, b2), -self.SUM_CLAMP,
                                self.SUM_CLAMP).sum(axis=2)
                Smax = jnp.clip(jnp.maximum(a, b2), -self.SUM_CLAMP,
                                self.SUM_CLAMP).sum(axis=2)
            rhs = l_rhs.astype(DT)[None, :]
            is_eq = (l_op == 1)[None, :]
            tt = lb[:, l_b] >= 1
            ff = ub[:, l_b] <= 0
            ent_t = jnp.where(is_eq, (Smin == rhs) & (Smax == rhs),
                              Smax <= rhs)
            ent_f = jnp.where(is_eq, (rhs < Smin) | (rhs > Smax), Smin > rhs)
            out = out & ((tt & ent_t) | (ff & ent_f)).all(axis=1)
        return out

    # -- native global constraints ------------------------------------

    def _element_cands(self, lb, ub):
        """JAX mirror of oracle._element_cands. Returns 4 (D, E) arrays:
        (idx_lo, idx_hi, res_lo, res_hi)."""
        li = lb[:, self.e_idx]                      # (D, E)
        ui = ub[:, self.e_idx]
        lr = lb[:, self.e_res][:, :, None]
        ur = ub[:, self.e_res][:, :, None]
        T = self.e_tab.shape[1]
        j = jax.lax.broadcasted_iota(I32, (1, 1, T), 2)
        tab = self.e_tab[None, :, :]
        in_win = (j >= li[:, :, None] - 1) & (j <= ui[:, :, None] - 1) & \
                 (j < self.e_len[None, :, None])
        ok = in_win & (tab >= lr) & (tab <= ur)
        # First/last valid position as masked-iota min/max reductions
        # (one reduction each instead of any+argmax+reverse+argmax):
        # no-candidate windows resolve to INF / NINF after the +1 shift.
        idx_lo = jnp.where(ok, j, INF - 1).min(axis=2) + 1
        idx_hi = jnp.where(ok, j, NINF - 1).max(axis=2) + 1
        res_lo = jnp.where(ok, tab, INF).min(axis=2)
        res_hi = jnp.where(ok, tab, NINF).max(axis=2)
        return idx_lo, idx_hi, res_lo, res_hi

    def _element_ask(self, lb, ub):
        li = jnp.clip(lb[:, self.e_idx], 1, self.e_len[None, :])
        ui = jnp.clip(ub[:, self.e_idx], 1, self.e_len[None, :])
        lr = lb[:, self.e_res]
        ur = ub[:, self.e_res]
        T = self.e_tab.shape[1]
        j = jax.lax.broadcasted_iota(I32, (1, 1, T), 2)
        tab = self.e_tab[None, :, :]
        in_win = (j >= li[:, :, None] - 1) & (j <= ui[:, :, None] - 1) & \
                 (j < self.e_len[None, :, None])
        tmin = jnp.where(in_win, tab, INF).min(axis=2)
        tmax = jnp.where(in_win, tab, NINF).max(axis=2)
        return (lr == ur) & (tmin == lr) & (tmax == lr)

    def _member_window(self, lb, ub):
        lx = lb[:, self.m_x]
        ux = ub[:, self.m_x]
        W = self.m_W
        wl = jnp.clip(lx - self.m_base[None, :], 0, W)
        wh = jnp.clip(ux - self.m_base[None, :] + 1, 0, W)
        chi = self.m_cnt_flat[wh + self.m_cnt_offs[None, :]]
        clo = self.m_cnt_flat[wl + self.m_cnt_offs[None, :]]
        c = chi - clo
        width = ux.astype(I64) - lx.astype(I64) + 1
        return lx, ux, c, width, W

    def _member_cands(self, lb, ub):
        """Returns (x_lo, x_hi, b_lo, b_hi) as (D, M) arrays."""
        lx, ux, c, width, W = self._member_window(lb, ub)
        lbb = lb[:, self.m_b]
        ubb = ub[:, self.m_b]
        b_lo = ((c.astype(I64) == width) & (width > 0)).astype(I32)
        b_hi = (c > 0).astype(I32)
        wl_i = jnp.clip(lx - self.m_base[None, :], 0, W - 1)
        wh_i = jnp.clip(ux - self.m_base[None, :], 0, W - 1)

        def row_take(flat_tab, idx2):
            return flat_tab[idx2 + self.m_offs[None, :]]

        nge = jnp.where(lx > self.m_top[None, :], INF,
                        row_take(self.m_next_ge, wl_i))
        ple = jnp.where(ux < self.m_base[None, :], NINF,
                        row_take(self.m_prev_le, wh_i))
        inhull_l = (lx >= self.m_base[None, :]) & (lx <= self.m_top[None, :])
        inhull_h = (ux >= self.m_base[None, :]) & (ux <= self.m_top[None, :])
        nout = jnp.where(inhull_l, row_take(self.m_next_out, wl_i), lx)
        pout = jnp.where(inhull_h, row_take(self.m_prev_out, wh_i), ux)
        tt = lbb >= 1
        ff = ubb <= 0
        x_lo = jnp.where(tt, nge, jnp.where(ff, nout, NINF))
        x_hi = jnp.where(tt, ple, jnp.where(ff, pout, INF))
        return (jnp.clip(x_lo, NINF, INF).astype(I32),
                jnp.clip(x_hi, NINF, INF).astype(I32), b_lo, b_hi)

    def _member_ask(self, lb, ub):
        lx, ux, c, width, W = self._member_window(lb, ub)
        lbb = lb[:, self.m_b]
        ubb = ub[:, self.m_b]
        return ((lbb >= 1) & (c.astype(I64) == width) & (width > 0)) | \
               ((ubb <= 0) & (c == 0))

    # -- store clamp --------------------------------------------------

    def _clamp_store(self, lb, ub):
        """Clamp every plane to the root box +/-1: lb <= ub0+1 and
        ub >= lb0-1 per var. Sound and lossless: ub only ever shrinks
        from ub0, so any lb driven past ub0 already implies bot (and
        vice versa) - the clamp preserves the bot signal with one unit
        of slack while bounding store values statically. That static
        bound is what lets per-bucket analysis run the linear kernel in
        native int32 (lin_fit32)."""
        return (jnp.minimum(lb, self._ub_cap[None, :]),
                jnp.maximum(ub, self._lb_floor[None, :]))

    # -- one AC-1 iteration ------------------------------------------

    def iteration(self, lb, ub):
        """One sweep over all propagators. lb/ub: (D, V) int32."""
        if self.P == 0:
            return lb, ub
        D = lb.shape[0]
        # Six consolidated gathers (one per role x bound), then per-op
        # rule compute on static slices (pure elementwise, fuses).
        LX, UX, LY, UY, LZ, UZ = self._role_gathers(lb, ub)
        # Role-major candidate layout (see plan.py): a plain concat of
        # per-group outputs.
        xls, yls, zls, xus, yus, zus = [], [], [], [], [], []
        for op, a, b in self.group_slices:
            cxl, cxu, cyl, cyu, czl, czu = _deduce_group(
                op, LX[:, a:b], UX[:, a:b], LY[:, a:b], UY[:, a:b],
                LZ[:, a:b], UZ[:, a:b])
            xls.append(cxl); yls.append(cyl); zls.append(czl)
            xus.append(cxu); yus.append(cyu); zus.append(czu)
        # Native element / membership candidate slots follow the 3P TNF
        # role slots: [3P | E idx | E res | M x | M b | neutral].
        extra_l, extra_u = [], []
        if self.E:
            il, ih, rl, rh = self._element_cands(lb, ub)
            extra_l += [il.astype(I32), rl.astype(I32)]
            extra_u += [ih.astype(I32), rh.astype(I32)]
        if self.M:
            xl, xh, bl, bh = self._member_cands(lb, ub)
            extra_l += [xl, bl]
            extra_u += [xh, bh]
        lin_b_l, lin_b_u = [], []
        for lbk, unit, fit32 in zip(self.lin_buckets, self.lin_unit,
                                    self.lin_fit32):
            tl, th, bl2, bh2 = self._linear_bucket_cands(lb, ub, lbk, unit,
                                                         fit32)
            extra_l.append(tl)
            extra_u.append(th)
            lin_b_l.append(bl2)
            lin_b_u.append(bh2)
        extra_l += lin_b_l
        extra_u += lin_b_u
        cand_l = jnp.concatenate(
            xls + yls + zls + extra_l +
            [jnp.full((D, 1), NINF, dtype=I32)], axis=1)
        cand_u = jnp.concatenate(
            xus + yus + zus + extra_u +
            [jnp.full((D, 1), INF, dtype=I32)], axis=1)

        new_l_parts, new_u_parts = [], []
        for start, count, idx in self.buckets:
            gl = cand_l[:, idx]  # (D, count, K)
            gu = cand_u[:, idx]
            nl = jnp.maximum(lb[:, start:start + count], gl.max(axis=-1))
            nu = jnp.minimum(ub[:, start:start + count], gu.min(axis=-1))
            new_l_parts.append(nl)
            new_u_parts.append(nu)
        tail_l = lb[:, self.n_active:]
        tail_u = ub[:, self.n_active:]
        if self.conf_idx is not None:
            # A deduction (lo, hi) into a var fixed at c is inconsistent
            # iff lo > c or hi < c; any such conflict raises the dummy
            # column's lb above its ub (0) => is_bot. Monotone (max), so
            # the fixpoint convergence logic is unaffected.
            off = self.conf_off[None, :]
            conf = ((cand_l[:, self.conf_idx] > off)
                    | (cand_u[:, self.conf_idx] < off)).any(axis=1)
            dl = jnp.maximum(tail_l[:, -1], conf.astype(I32))
            tail_l = jnp.concatenate([tail_l[:, :-1], dl[:, None]], axis=1)
        lb2 = jnp.concatenate(new_l_parts + [tail_l], axis=1)
        ub2 = jnp.concatenate(new_u_parts + [tail_u], axis=1)
        # Maintain the root-box invariant the int32 linear path relies
        # on (lossless for non-bot lanes, see _clamp_store).
        return self._clamp_store(lb2, ub2)

    # -- transposed-plane (V, D) sweep --------------------------------
    #
    # Identical semantics to `iteration`, but every plane/candidate
    # array is (V, D) / (C, D) with the dive axis minor, so the
    # candidate planes are assembled without transposing copies when
    # XLA's layout assignment picks dive-minor storage for the gather
    # operands inside the fixpoint loop.

    def _element_cands_t(self, lbT, ubT):
        li = lbT[self.e_idx]                        # (E, D)
        ui = ubT[self.e_idx]
        lr = lbT[self.e_res][:, None, :]            # (E, 1, D)
        ur = ubT[self.e_res][:, None, :]
        T = self.e_tab.shape[1]
        j = jax.lax.broadcasted_iota(I32, (1, T, 1), 1)
        tab = self.e_tab[:, :, None]                # (E, T, 1)
        in_win = (j >= li[:, None, :] - 1) & (j <= ui[:, None, :] - 1) & \
                 (j < self.e_len[:, None, None])
        ok = in_win & (tab >= lr) & (tab <= ur)     # (E, T, D)
        idx_lo = jnp.where(ok, j, INF - 1).min(axis=1) + 1
        idx_hi = jnp.where(ok, j, NINF - 1).max(axis=1) + 1
        res_lo = jnp.where(ok, tab, INF).min(axis=1)
        res_hi = jnp.where(ok, tab, NINF).max(axis=1)
        return idx_lo, idx_hi, res_lo, res_hi

    def _member_cands_t(self, lbT, ubT):
        lx = lbT[self.m_x]                          # (M, D)
        ux = ubT[self.m_x]
        W = self.m_W
        wl = jnp.clip(lx - self.m_base[:, None], 0, W)
        wh = jnp.clip(ux - self.m_base[:, None] + 1, 0, W)
        chi = self.m_cnt_flat[wh + self.m_cnt_offs[:, None]]
        clo = self.m_cnt_flat[wl + self.m_cnt_offs[:, None]]
        c = chi - clo
        width = ux.astype(I64) - lx.astype(I64) + 1
        lbb = lbT[self.m_b]
        ubb = ubT[self.m_b]
        b_lo = ((c.astype(I64) == width) & (width > 0)).astype(I32)
        b_hi = (c > 0).astype(I32)
        wl_i = jnp.clip(lx - self.m_base[:, None], 0, W - 1)
        wh_i = jnp.clip(ux - self.m_base[:, None], 0, W - 1)

        def row_take(flat_tab, idx2):
            return flat_tab[idx2 + self.m_offs[:, None]]

        nge = jnp.where(lx > self.m_top[:, None], INF,
                        row_take(self.m_next_ge, wl_i))
        ple = jnp.where(ux < self.m_base[:, None], NINF,
                        row_take(self.m_prev_le, wh_i))
        inhull_l = (lx >= self.m_base[:, None]) & (lx <= self.m_top[:, None])
        inhull_h = (ux >= self.m_base[:, None]) & (ux <= self.m_top[:, None])
        nout = jnp.where(inhull_l, row_take(self.m_next_out, wl_i), lx)
        pout = jnp.where(inhull_h, row_take(self.m_prev_out, wh_i), ux)
        tt = lbb >= 1
        ff = ubb <= 0
        x_lo = jnp.where(tt, nge, jnp.where(ff, nout, NINF))
        x_hi = jnp.where(tt, ple, jnp.where(ff, pout, INF))
        return (jnp.clip(x_lo, NINF, INF).astype(I32),
                jnp.clip(x_hi, NINF, INF).astype(I32), b_lo, b_hi)

    def _linear_bucket_cands_t(self, lbT, ubT, lbk, unit=False, fit32=False):
        l_b, l_op, l_rhs, l_coef, l_var = lbk
        DT = I32 if fit32 else I64
        D = lbT.shape[1]
        C, K = l_coef.shape
        xl = lbT[l_var.reshape(-1)].reshape(C, K, D).astype(DT)
        xu = ubT[l_var.reshape(-1)].reshape(C, K, D).astype(DT)
        c = l_coef.astype(DT)[:, :, None]
        a = c * xl
        b2 = c * xu
        if fit32:
            tmin = jnp.minimum(a, b2)
            tmax = jnp.maximum(a, b2)
        else:
            tmin = jnp.clip(jnp.minimum(a, b2), -self.SUM_CLAMP,
                            self.SUM_CLAMP)
            tmax = jnp.clip(jnp.maximum(a, b2), -self.SUM_CLAMP,
                            self.SUM_CLAMP)
        Smin = tmin.sum(axis=1)                     # (C, D)
        Smax = tmax.sum(axis=1)
        rhs = l_rhs.astype(DT)[:, None]             # (C, 1)
        is_eq = (l_op == 1)[:, None]
        b_lo = jnp.where(is_eq, (Smin == rhs) & (Smax == rhs),
                         Smax <= rhs).astype(I32)
        b_hi = jnp.where(is_eq, (Smin <= rhs) & (rhs <= Smax),
                         Smin <= rhs).astype(I32)
        tt = (lbT[l_b] >= 1)[:, None, :]            # (C, 1, D)
        ff = (ubT[l_b] <= 0)[:, None, :]
        live = (l_coef != 0)[:, :, None]
        csafe = jnp.where(live, c, 1)
        R = rhs[:, :, None] - (Smin[:, None, :] - tmin)
        rhs2 = jnp.where(is_eq, rhs, rhs + 1)[:, :, None]
        R2 = rhs2 - (Smax[:, None, :] - tmax)
        if unit:
            q_le = ceil_le = R * csafe
            q_ge = ceil_ge = R2 * csafe
        else:
            q_le = jnp.floor_divide(R, csafe)
            ceil_le = q_le + ((R - q_le * csafe) != 0)
            q_ge = jnp.floor_divide(R2, csafe)
            ceil_ge = q_ge + ((R2 - q_ge * csafe) != 0)
        cpos = (l_coef > 0)[:, :, None]
        is_eq3 = is_eq[:, :, None]
        ge_act = (is_eq3 & tt) | (~is_eq3 & ff)
        le_act = tt
        term_hi = jnp.where(live & le_act & cpos, q_le, INF)
        term_hi = jnp.minimum(term_hi,
                              jnp.where(live & ge_act & ~cpos, q_ge, INF))
        term_lo = jnp.where(live & le_act & ~cpos, ceil_le, NINF)
        term_lo = jnp.maximum(term_lo,
                              jnp.where(live & ge_act & cpos, ceil_ge, NINF))
        term_lo = jnp.clip(term_lo, NINF, INF).astype(I32).reshape(C * K, D)
        term_hi = jnp.clip(term_hi, NINF, INF).astype(I32).reshape(C * K, D)
        return term_lo, term_hi, b_lo, b_hi

    def iteration_t(self, lbT, ubT):
        """One AC-1 sweep on transposed (V, D) planes (== iteration)."""
        if self.P == 0:
            return lbT, ubT
        D = lbT.shape[1]
        LX, UX, LY, UY, LZ, UZ = self._role_gathers(lbT, ubT,
                                                    transposed=True)
        xls, yls, zls, xus, yus, zus = [], [], [], [], [], []
        for op, a, b in self.group_slices:
            cxl, cxu, cyl, cyu, czl, czu = _deduce_group(
                op, LX[a:b], UX[a:b], LY[a:b], UY[a:b], LZ[a:b], UZ[a:b])
            xls.append(cxl); yls.append(cyl); zls.append(czl)
            xus.append(cxu); yus.append(cyu); zus.append(czu)
        extra_l, extra_u = [], []
        if self.E:
            il, ih, rl, rh = self._element_cands_t(lbT, ubT)
            extra_l += [il.astype(I32), rl.astype(I32)]
            extra_u += [ih.astype(I32), rh.astype(I32)]
        if self.M:
            xl, xh, bl, bh = self._member_cands_t(lbT, ubT)
            extra_l += [xl, bl]
            extra_u += [xh, bh]
        lin_b_l, lin_b_u = [], []
        for lbk, unit, fit32 in zip(self.lin_buckets, self.lin_unit,
                                    self.lin_fit32):
            tl, th, bl2, bh2 = self._linear_bucket_cands_t(
                lbT, ubT, lbk, unit, fit32)
            extra_l.append(tl)
            extra_u.append(th)
            lin_b_l.append(bl2)
            lin_b_u.append(bh2)
        extra_l += lin_b_l
        extra_u += lin_b_u
        cand_l = jnp.concatenate(
            xls + yls + zls + extra_l +
            [jnp.full((1, D), NINF, dtype=I32)], axis=0)
        cand_u = jnp.concatenate(
            xus + yus + zus + extra_u +
            [jnp.full((1, D), INF, dtype=I32)], axis=0)
        new_l_parts, new_u_parts = [], []
        for start, count, idx in self.buckets:
            gl = cand_l[idx]                        # (count, K, D)
            gu = cand_u[idx]
            nl = jnp.maximum(lbT[start:start + count], gl.max(axis=1))
            nu = jnp.minimum(ubT[start:start + count], gu.min(axis=1))
            new_l_parts.append(nl)
            new_u_parts.append(nu)
        tail_l = lbT[self.n_active:]
        tail_u = ubT[self.n_active:]
        if self.conf_idx is not None:
            # Transposed twin of the singleton-tail conflict fold.
            off = self.conf_off[:, None]
            conf = ((cand_l[self.conf_idx] > off)
                    | (cand_u[self.conf_idx] < off)).any(axis=0)
            dl = jnp.maximum(tail_l[-1], conf.astype(I32))
            tail_l = jnp.concatenate([tail_l[:-1], dl[None, :]], axis=0)
        lb2 = jnp.concatenate(new_l_parts + [tail_l], axis=0)
        ub2 = jnp.concatenate(new_u_parts + [tail_u], axis=0)
        return (jnp.minimum(lb2, self._ub_cap[:, None]),
                jnp.maximum(ub2, self._lb_floor[:, None]))

    def fixpoint_t(self, lbT, ubT, max_iters: int = 100000,
                   unroll: int = 1):
        """AC-1 fixpoint on (V, D) planes. Returns (lbT, ubT, iters,
        unconv). See `fixpoint` for the unroll and unconv rationale."""
        if self.P == 0:
            z = jnp.zeros(lbT.shape[1], dtype=I32)
            return lbT, ubT, z, z != 0
        unroll = max(1, unroll)

        def cond(carry):
            _, _, _, changed, it = carry
            return jnp.logical_and(changed.any(), it < max_iters)

        def body(carry):
            lbT, ubT, iters, changed, it = carry
            lb2, ub2 = lbT, ubT
            m = changed
            for _ in range(unroll):
                lb3, ub3 = self.iteration_t(lb2, ub2)
                iters = iters + m.astype(I32)
                dch = jnp.any((lb3 != lb2) | (ub3 != ub2), axis=0)
                bot = jnp.any(lb3 > ub3, axis=0)
                m = m & dch & ~bot
                lb2, ub2 = lb3, ub3
            return lb2, ub2, iters, m, it + unroll

        zero_lane = lbT[0] * 0
        init = (lbT, ubT, zero_lane, zero_lane == 0, zero_lane[0])
        lbT, ubT, iters, m, _ = jax.lax.while_loop(cond, body, init)
        return lbT, ubT, iters + 1, m

    # -- WAC1: per-group local fixpoints ------------------------------

    def _group_local_fixpoint(self, lb, ub, gi: int, inner_cap: int):
        """Run op-group `gi` to a local fixpoint (capped), scatter-meet
        updates directly into the store so later groups see them.

        The analog of the reference's warp fixpoint
        (`warp_fixpoint`, barebones_dive_and_solve.hpp:955 /
        fixpoint.hpp WAC1): a warp's 32 propagators iterate to local
        convergence before the next warp runs; here the "warp" is an
        op-group and the scatter-meet (`.at[].max/min`, duplicate
        indices combined monotonically) replaces CUDA atomic min/max.
        Returns (lb, ub, inner_iters (D,))."""
        op, a, b = self.group_slices[gi]
        xs, ys, zs = self.all_x[a:b], self.all_y[a:b], self.all_z[a:b]

        def body(carry):
            lb, ub, _, it, iters = carry
            cxl, cxu, cyl, cyu, czl, czu = _deduce_group(
                op, lb[:, xs], ub[:, xs], lb[:, ys], ub[:, ys],
                lb[:, zs], ub[:, zs])
            lb2 = lb.at[:, xs].max(cxl).at[:, ys].max(cyl).at[:, zs].max(czl)
            ub2 = ub.at[:, xs].min(cxu).at[:, ys].min(cyu).at[:, zs].min(czu)
            lb2, ub2 = self._clamp_store(lb2, ub2)
            ch = jnp.any((lb2 != lb) | (ub2 != ub), axis=1)
            bot = jnp.any(lb2 > ub2, axis=1)
            return lb2, ub2, ch & ~bot, it + 1, iters + ch.astype(I32)

        def cond(carry):
            return jnp.logical_and(carry[2].any(), carry[3] < inner_cap)

        zero_lane = lb[:, 0] * 0
        init = (lb, ub, zero_lane == 0, zero_lane[0], zero_lane)
        lb, ub, _, _, iters = jax.lax.while_loop(cond, body, init)
        return lb, ub, iters

    def sweep_wac1(self, lb, ub, inner_cap: int = 16):
        """One WAC1 sweep: each op-group reaches a local fixpoint in
        turn (Gauss-Seidel over groups - later groups read earlier
        groups' updates within the same sweep), then one pass of the
        native element/member/linear propagators via scatter-meet.
        Returns (lb, ub, inner_iters (D,))."""
        D = lb.shape[0]
        iters = jnp.zeros(D, dtype=I32)
        for gi in range(len(self.group_slices)):
            lb, ub, it = self._group_local_fixpoint(lb, ub, gi, inner_cap)
            iters = iters + it
        if self.E:
            il, ih, rl, rh = self._element_cands(lb, ub)
            lb = lb.at[:, self.e_idx].max(il.astype(I32))
            ub = ub.at[:, self.e_idx].min(ih.astype(I32))
            lb = lb.at[:, self.e_res].max(rl.astype(I32))
            ub = ub.at[:, self.e_res].min(rh.astype(I32))
        if self.M:
            xl, xh, bl, bh = self._member_cands(lb, ub)
            lb = lb.at[:, self.m_x].max(xl).at[:, self.m_b].max(bl)
            ub = ub.at[:, self.m_x].min(xh).at[:, self.m_b].min(bh)
        lb, ub = self._clamp_store(lb, ub)
        for lbk, unit, fit32 in zip(self.lin_buckets, self.lin_unit,
                                    self.lin_fit32):
            l_b, l_op, l_rhs, l_coef, l_var = lbk
            tl, th, b_lo, b_hi = self._linear_bucket_cands(lb, ub, lbk, unit,
                                                           fit32)
            flat_var = l_var.reshape(-1)
            lb = lb.at[:, flat_var].max(tl).at[:, l_b].max(b_lo)
            ub = ub.at[:, flat_var].min(th).at[:, l_b].min(b_hi)
            # Re-establish the box invariant before the next bucket's
            # int32 path reads these planes.
            lb, ub = self._clamp_store(lb, ub)
        return lb, ub, iters

    def fixpoint_wac1(self, lb, ub, max_iters: int = 100000,
                      inner_cap: int = 16):
        """WAC1 fixpoint: outer loop of `sweep_wac1` until no change.
        Returns (lb, ub, sweeps (D,) int32, unconv) - sweeps counts
        outer iterations, comparable to `fixpoint`'s AC-1 count."""
        if self.P == 0:
            z = jnp.zeros(lb.shape[0], dtype=I32)
            return lb, ub, z, z != 0

        def cond(carry):
            _, _, _, changed, it = carry
            return jnp.logical_and(changed.any(), it < max_iters)

        def body(carry):
            lb, ub, sweeps, changed, it = carry
            lb2, ub2, _ = self.sweep_wac1(lb, ub, inner_cap)
            dchanged = jnp.any((lb2 != lb) | (ub2 != ub), axis=1)
            bot = jnp.any(lb2 > ub2, axis=1)
            sweeps = sweeps + changed.astype(I32)
            return lb2, ub2, sweeps, dchanged & ~bot, it + 1

        zero_lane = lb[:, 0] * 0
        init = (lb, ub, zero_lane, zero_lane == 0, zero_lane[0])
        lb, ub, sweeps, m, _ = jax.lax.while_loop(cond, body, init)
        return lb, ub, sweeps + 1, m

    # -- fixpoint -----------------------------------------------------

    def fixpoint(self, lb, ub, max_iters: int = 100000,
                 unroll: int = 1):
        """AC-1 fixpoint. Returns (lb, ub, iters (D,) int32, unconv
        (D,) bool).

        `unconv` marks lanes still changing when the loop exited on
        `max_iters` (empty when the loop converged). The per-step cost
        of this while loop is its TRIP count — the max over lanes of
        sweeps-to-convergence — while the useful work is the sum, so a
        tight cap can buy a multiple in step rate. The engine HOLDS unconv
        lanes (no branch, no node count) so a tight cap never inflates
        the search tree: a held lane just spends another step's sweeps
        before it is classified (engine.step II/IV).

        `unroll` sweeps run inside each while iteration, amortizing a
        while-loop iteration's fixed overhead (body launches, the
        convergence test) over K sweeps. Semantics stay the exact
        fixpoint: sweeps are monotone and idempotent at the fixpoint,
        so overshooting a converged lane by <K sweeps changes nothing;
        the convergence check still gates exit."""
        if self.P == 0:
            D = lb.shape[0]
            z = jnp.zeros(D, dtype=I32)
            return lb, ub, z, z != 0
        unroll = max(1, unroll)

        def cond(carry):
            _, _, _, changed, it = carry
            return jnp.logical_and(changed.any(), it < max_iters)

        def body(carry):
            lb, ub, iters, changed, it = carry
            lb2, ub2 = lb, ub
            m = changed
            for _ in range(unroll):
                lb3, ub3 = self.iteration(lb2, ub2)
                iters = iters + m.astype(I32)
                dch = jnp.any((lb3 != lb2) | (ub3 != ub2), axis=1)
                bot = jnp.any(lb3 > ub3, axis=1)
                m = m & dch & ~bot
                lb2, ub2 = lb3, ub3
            return lb2, ub2, iters, m, it + unroll

        # Derive loop-carry inits from lb so they inherit its
        # varying-manual-axes type under shard_map (fresh constants
        # would be 'unvarying' and fail the while_loop carry check).
        zero_lane = lb[:, 0] * 0
        init = (lb, ub, zero_lane, zero_lane == 0, zero_lane[0])
        lb, ub, iters, m, _ = jax.lax.while_loop(cond, body, init)
        return lb, ub, iters + 1, m

    def fixed_sweeps(self, lb, ub, n: int):
        """Exactly n AC-1 sweeps, no convergence check (lockstep, no
        while_loop). Sound: meets only; callers treat non-fixpoint
        stores conservatively. Returns (lb, ub, iters (D,), unconv):
        unconv is all-False — fixed mode BRANCHES at non-fixpoint
        stores by design, so no lane is ever held."""
        if self.P == 0:
            z = jnp.zeros(lb.shape[0], dtype=I32)
            return lb, ub, z, z != 0
        for _ in range(n):
            lb, ub = self.iteration(lb, ub)
        return (lb, ub, jnp.full(lb.shape[0], n, dtype=I32),
                jnp.zeros(lb.shape[0], dtype=bool))

    # -- entailment ---------------------------------------------------

    def all_entailed(self, lb, ub):
        """(D,) bool: every propagator entailed (solution detection,
        barebones_dive_and_solve.hpp:992-1009)."""
        if self.P == 0:
            return jnp.ones(lb.shape[0], dtype=bool)
        LX, UX = lb[:, self.all_x], ub[:, self.all_x]
        LY, UY = lb[:, self.all_y], ub[:, self.all_y]
        LZ, UZ = lb[:, self.all_z], ub[:, self.all_z]
        out = jnp.ones(lb.shape[0], dtype=bool)
        for op, a, b in self.group_slices:
            ok = _ask_group(op, LX[:, a:b], UX[:, a:b], LY[:, a:b],
                            UY[:, a:b], LZ[:, a:b], UZ[:, a:b])
            out = out & ok.all(axis=1)
        if self.E:
            out = out & self._element_ask(lb, ub).all(axis=1)
        if self.M:
            out = out & self._member_ask(lb, ub).all(axis=1)
        if self.lin_buckets:
            out = out & self._linear_ask_all(lb, ub)
        return out

    def is_bot(self, lb, ub):
        return jnp.any(lb > ub, axis=1)
