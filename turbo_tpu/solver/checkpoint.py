"""Cross-run checkpoint/resume of the batched search state.

The reference has no cross-run checkpointing (SURVEY.md §5: within-run
snapshot/restore only). Because this engine's entire search state is a
flat pytree of arrays (SearchState), saving and resuming a run is
nearly free — useful for preemptible jobs and long proofs.
"""
from __future__ import annotations

import pickle
from typing import Optional

import jax
import numpy as np

from .engine import BatchedSolver, SearchState

# v2: SearchState gained ext_bound (multi-host)
# v3: SearchState gained fp_cap (traced fixpoint cap)
# v4: payload gained data_digest — shapes alone cannot tell two plans
#     apart when only plan DATA differs (e.g. -shave tightened lb0/ub0
#     without dropping a propagator): resuming lane state against
#     different root bounds would remap subproblem bit-paths to
#     different subtrees, silently breaking exhaustiveness.
# v5: SearchState gained the EPS subproblem-root table (tab_*); payload
#     gained num_sub_total (k pins the table shape and the bit-path
#     space) and `extras` (resplit/steal accounting freeze:
#     a resumed run must keep reporting coarse 2^k subproblem units).
FORMAT_VERSION = 5


def save_state(solver: BatchedSolver, st: SearchState, path: str,
               num_shards: int = 1, extras: Optional[dict] = None):
    host = jax.tree.map(lambda x: np.asarray(jax.device_get(x)), st)
    payload = {
        "format": FORMAT_VERSION,
        "shape_signature": solver.plan.shape_signature,
        "data_digest": solver.plan.data_digest,
        "num_dives": solver.cfg.num_dives,
        "max_depth": solver.cfg.max_depth,
        "num_shards": num_shards,
        "num_sub_total": solver.num_sub_total,
        "use_table": solver.use_table,
        "state": host._asdict(),
        "extras": dict(extras or {}),
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_state(solver: BatchedSolver, path: str, num_shards: int = 1,
               device_put=None):
    """Returns (restored device state, extras dict), or None on any
    mismatch.

    `device_put` optionally places each leaf (used by the sharded
    solver to restore with the mesh sharding)."""
    import os
    import sys

    def _reject(why):
        # A rejected checkpoint silently restarting a long proof from
        # scratch (and then overwriting the file) would be hours lost
        # with no trace — always say why.
        print(f"% warning: checkpoint {path} ignored ({why}); "
              f"starting fresh", file=sys.stderr, flush=True)
        return None

    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            payload = pickle.load(f)
        if payload.get("format") != FORMAT_VERSION:
            return _reject(f"format {payload.get('format')} != "
                           f"{FORMAT_VERSION}")
        if payload["shape_signature"] != solver.plan.shape_signature:
            return _reject("different instance/plan shapes")
        if payload["data_digest"] != solver.plan.data_digest:
            return _reject("same shapes but different plan data "
                           "(instance content or presolve flags differ)")
        if payload["num_dives"] != solver.cfg.num_dives or \
                payload["max_depth"] != solver.cfg.max_depth:
            return _reject("different num_dives/max_depth config")
        if payload.get("num_shards", 1) != num_shards:
            return _reject("different shard count")
        if payload.get("num_sub_total") != solver.num_sub_total:
            return _reject("different EPS split (2^k)")
        if payload.get("use_table") != solver.use_table:
            return _reject("different table mode")
        import jax.numpy as jnp

        put = device_put or jnp.asarray
        fields = dict(payload["state"])
        # fp_cap is a tuning knob, not search state: the RESUMING run's
        # configuration wins (a snapshot from a cap-16 bench must not
        # pin a later cap-10000 CLI run to 16).
        fields["fp_cap"] = np.full_like(np.asarray(fields["fp_cap"]),
                                        solver.cfg.fp_max_iters)
        st = SearchState(**{k: put(np.asarray(v))
                            for k, v in fields.items()})
        return st, dict(payload.get("extras", {}))
    except Exception as e:
        return _reject(f"{type(e).__name__}: {e}")
