"""Exact parity of the device propagation kernels with the numpy rules.

`check_kernel_parity` runs the kernels of `propagate_jax.py` on random
sub-boxes of a plan's root and compares them with plain numpy:

  - one sweep, in both plane layouts (dv `iteration`, vd
    `iteration_t`), against `numpy_sweep`: the `deduce_np` rules
    applied to the same plan as a Jacobi step, meeting candidates with
    scatter `np.maximum.at` / `np.minimum.at` where the kernel gathers
    through its bucketed incidence tables;
  - the AC-1 fixpoint in both layouts against `numpy_fixpoint` (planes,
    sweep counts and held-lane masks), and the WAC1 fixpoint on its
    failure flags and on the stores of the lanes that did not fail
    (the greatest common fixpoint is unique, whatever the order);
  - the entailment and failure flags at the fixpoint;
  - the oracle's own Gauss-Seidel fixpoint (`oracle.PropTable`, TNF
    ids, unsimplified network): the same failures, and the same stores
    where no failure.

Everything compared is int32/int64 arithmetic (no floating point), so
the comparison is exact equality. Any mismatch raises AssertionError.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.ops import INF, NINF
from . import deduce_np
from .oracle import PropTable


def random_subboxes(plan, n: int, seed: int = 0):
    """`n` random sub-boxes of the plan's root store, (n, V) int32 in
    permuted ids: each narrows 1-4 real active variables to a random
    sub-interval of their root domain."""
    rng = np.random.default_rng(seed)
    real = np.nonzero(plan.inv_perm[:plan.n_active] >= 0)[0]
    real = real[plan.lb0[real] < plan.ub0[real]]
    lb = np.repeat(plan.lb0[None, :], n, 0).astype(np.int64)
    ub = np.repeat(plan.ub0[None, :], n, 0).astype(np.int64)
    for d in range(n):
        if not len(real):
            break
        k = min(len(real), int(rng.integers(1, 5)))
        for v in rng.choice(real, size=k, replace=False):
            lo = int(rng.integers(lb[d, v], ub[d, v] + 1))
            hi = int(rng.integers(lo, ub[d, v] + 1))
            lb[d, v], ub[d, v] = lo, hi
    return lb.astype(np.int32), ub.astype(np.int32)


def _table(**arrays) -> PropTable:
    """A PropTable holding the given plan-space arrays, so that its
    element/member/linear methods read the plan's tables."""
    t = PropTable.__new__(PropTable)
    t.__dict__.update({k: np.asarray(v, dtype=np.int64)
                       if isinstance(v, np.ndarray) else v
                       for k, v in arrays.items()})
    return t


def _native_tables(plan):
    """Plan-space views of the native element/member/linear tables."""
    el = _table(E=plan.E, e_idx=plan.e_idx, e_res=plan.e_res,
                e_len=plan.e_len, e_tab=plan.e_tab) if plan.E else None
    mem = _table(M=plan.M, m_W=plan.m_cnt.shape[1] - 1, m_x=plan.m_x,
                 m_b=plan.m_b, m_base=plan.m_base, m_top=plan.m_top,
                 m_cnt=plan.m_cnt, m_next_ge=plan.m_next_ge,
                 m_prev_le=plan.m_prev_le, m_next_out=plan.m_next_out,
                 m_prev_out=plan.m_prev_out) if plan.M else None
    lins = [_table(L=len(b), l_b=b, l_op=op, l_rhs=rhs, l_coef=coef,
                   l_var=var)
            for b, op, rhs, coef, var in plan.lin_buckets]
    return el, mem, lins


def _candidates(plan, lb, ub):
    """Every (target var, lo, hi) candidate of one sweep over the plan
    for a single store: target (C,), lo (C,), hi (C,) int64."""
    tgt, lo, hi = [], [], []
    for op, xs, ys, zs in plan.groups:
        c = deduce_np.deduce(op, lb[xs], ub[xs], lb[ys], ub[ys],
                             lb[zs], ub[zs])
        for ids, cl, cu in ((xs, c[0], c[1]), (ys, c[2], c[3]),
                            (zs, c[4], c[5])):
            tgt.append(ids); lo.append(cl); hi.append(cu)
    el, mem, lins = _native_tables(plan)
    if el is not None:
        il, ih, rl, rh = el._element_cands(lb, ub)
        tgt += [el.e_idx, el.e_res]; lo += [il, rl]; hi += [ih, rh]
    if mem is not None:
        xl, xh, bl, bh = mem._member_cands(lb, ub)
        tgt += [mem.m_x, mem.m_b]; lo += [xl, bl]; hi += [xh, bh]
    for lin in lins:
        tl, th, bl, bh = lin._linear_cands(lb, ub)
        tgt += [lin.l_var.ravel(), lin.l_b]
        lo += [tl.ravel(), bl]; hi += [th.ravel(), bh]
    return (np.concatenate(tgt).astype(np.int64),
            np.concatenate(lo).astype(np.int64),
            np.concatenate(hi).astype(np.int64))


def numpy_sweep(plan, lb, ub):
    """One Jacobi sweep of every propagator of the plan over (D, V)
    stores, in numpy. Same store semantics as the device sweep:
    candidates meet into the active region; a candidate for a
    root-fixed variable of the singleton tail that excludes its value
    raises the dummy column's lb (a failure); the synthetic slots
    (spill, dummies) are never written; every plane is clamped to the
    root box +/- 1."""
    V, na = plan.V, plan.n_active
    lb = np.asarray(lb, dtype=np.int64)
    ub = np.asarray(ub, dtype=np.int64)
    out_l, out_u = lb.copy(), ub.copy()
    for d in range(lb.shape[0]):
        tgt, clo, chi = _candidates(plan, lb[d], ub[d])
        act = tgt < na
        np.maximum.at(out_l[d], tgt[act], clo[act])
        np.minimum.at(out_u[d], tgt[act], chi[act])
        tail = (tgt >= na) & (tgt < V - 3)
        c = plan.lb0[tgt[tail]].astype(np.int64)
        if ((clo[tail] > c) | (chi[tail] < c)).any():
            out_l[d, V - 1] = max(out_l[d, V - 1], 1)
    out_l = np.minimum(out_l, plan.ub0.astype(np.int64) + 1)
    out_u = np.maximum(out_u, plan.lb0.astype(np.int64) - 1)
    return out_l.astype(np.int32), out_u.astype(np.int32)


def numpy_fixpoint(plan, lb, ub, max_iters: int = 100000):
    """`numpy_sweep` iterated exactly as `PropagatorKernels.fixpoint`
    iterates its sweep: every lane is swept while any lane is still
    changing; a lane stops counting once it is unchanged or failed.
    Returns (lb, ub, iters (D,), unconverged (D,))."""
    m = np.ones(lb.shape[0], dtype=bool)
    iters = np.zeros(lb.shape[0], dtype=np.int32)
    it = 0
    while m.any() and it < max_iters:
        lb2, ub2 = numpy_sweep(plan, lb, ub)
        iters += m
        changed = ((lb2 != lb) | (ub2 != ub)).any(axis=1)
        m = m & changed & ~(lb2 > ub2).any(axis=1)
        lb, ub = lb2, ub2
        it += 1
    return lb, ub, iters + 1, m


def numpy_entailed(plan, lb, ub):
    """(D,) bool: every propagator of the plan entailed (numpy)."""
    el, mem, lins = _native_tables(plan)
    out = np.ones(lb.shape[0], dtype=bool)
    for d in range(lb.shape[0]):
        l = lb[d].astype(np.int64)
        u = ub[d].astype(np.int64)
        ok = all(deduce_np.ask(op, l[xs], u[xs], l[ys], u[ys],
                               l[zs], u[zs]).all()
                 for op, xs, ys, zs in plan.groups)
        if el is not None:
            ok = ok and el._element_ask(l, u).all()
        if mem is not None:
            ok = ok and mem._member_ask(l, u).all()
        for lin in lins:
            ok = ok and lin._linear_ask(l, u).all()
        out[d] = ok
    return out


def _eq(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = np.argwhere(got != want) if got.shape == want.shape else []
        raise AssertionError(
            f"kernel parity: {name} differs from the numpy reference "
            f"(shape {got.shape} vs {want.shape}; first mismatches "
            f"{[tuple(int(i) for i in b) for b in bad[:5]]})")


def check_kernel_parity(tnf, plan, num_dives: int, num_boxes: int = 64,
                        seed: int = 0, wac1_inner_cap: int = 16) -> Dict:
    """Compare the device kernels with the numpy reference on
    `num_boxes` random sub-boxes of the root, run at `num_dives` lanes
    (the boxes tiled over the lanes). Raises AssertionError on the
    first mismatch; returns counts for the report."""
    import jax
    import jax.numpy as jnp

    from .propagate_jax import PropagatorKernels

    kernels = PropagatorKernels(plan)
    blb, bub = random_subboxes(plan, num_boxes, seed)
    reps = -(-num_dives // num_boxes)
    lane_box = np.tile(np.arange(num_boxes), reps)[:num_dives]
    lb = jnp.asarray(blb[lane_box])
    ub = jnp.asarray(bub[lane_box])

    # One sweep, both layouts.
    nl, nu = numpy_sweep(plan, blb, bub)
    dl, du = jax.jit(kernels.iteration)(lb, ub)
    _eq("dv sweep lb", np.asarray(dl), nl[lane_box])
    _eq("dv sweep ub", np.asarray(du), nu[lane_box])
    tl, tu = jax.jit(kernels.iteration_t)(lb.T, ub.T)
    _eq("vd sweep lb", np.asarray(tl).T, nl[lane_box])
    _eq("vd sweep ub", np.asarray(tu).T, nu[lane_box])

    # AC-1 fixpoint, both layouts: planes, sweep counts, held lanes.
    fl, fu, fit, fm = numpy_fixpoint(plan, blb, bub)
    fl_l, fu_l = fl[lane_box], fu[lane_box]
    for name, fn, args, tr in (
            ("dv fixpoint", kernels.fixpoint, (lb, ub), False),
            ("vd fixpoint", kernels.fixpoint_t, (lb.T, ub.T), True)):
        gl, gu, git, gm = jax.jit(fn)(*args)
        gl, gu = np.asarray(gl), np.asarray(gu)
        if tr:
            gl, gu = gl.T, gu.T
        _eq(f"{name} lb", gl, fl_l)
        _eq(f"{name} ub", gu, fu_l)
        _eq(f"{name} sweeps", np.asarray(git), fit[lane_box])
        _eq(f"{name} held lanes", np.asarray(gm), fm[lane_box])

    # Failure and entailment flags at the fixpoint.
    bot = (fl > fu).any(axis=1)
    _eq("failure flags", np.asarray(jax.jit(kernels.is_bot)(
        jnp.asarray(fl_l), jnp.asarray(fu_l))), bot[lane_box])
    ent = numpy_entailed(plan, fl, fu)
    _eq("entailment flags", np.asarray(jax.jit(kernels.all_entailed)(
        jnp.asarray(fl_l), jnp.asarray(fu_l))), ent[lane_box])

    # WAC1: same failures; same stores where no failure.
    wl, wu, _, _ = jax.jit(lambda a, b: kernels.fixpoint_wac1(
        a, b, inner_cap=wac1_inner_cap))(lb, ub)
    wl, wu = np.asarray(wl), np.asarray(wu)
    _eq("wac1 failure flags", (wl > wu).any(axis=1), bot[lane_box])
    live = ~bot[lane_box]
    _eq("wac1 fixpoint lb", wl[live], fl_l[live])
    _eq("wac1 fixpoint ub", wu[live], fu_l[live])

    # The oracle's fixpoint on the TNF network, where no failure.
    table = PropTable(tnf)
    kept = ~plan.dropped if plan.dropped is not None else \
        np.ones(tnf.num_vars, dtype=bool)
    act = plan.inv_perm >= 0
    for d in range(num_boxes):
        l = tnf.lb0.astype(np.int64).copy()
        u = tnf.ub0.astype(np.int64).copy()
        l[plan.inv_perm[act]] = blb[d][act]
        u[plan.inv_perm[act]] = bub[d][act]
        _, _, obot = table.propagate(l, u)
        if obot != bot[d]:
            raise AssertionError(f"kernel parity: box {d} failure "
                                 f"{bot[d]} vs the oracle's {obot}")
        if obot:
            continue
        _eq(f"oracle fixpoint lb (box {d})", fl[d][plan.perm][kept], l[kept])
        _eq(f"oracle fixpoint ub (box {d})", fu[d][plan.perm][kept], u[kept])
    return {"lanes": num_dives, "boxes": num_boxes,
            "failed": int(bot.sum()), "entailed": int(ent.sum()),
            "max_sweeps": int(fit.max())}
