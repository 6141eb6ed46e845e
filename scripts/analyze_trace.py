#!/usr/bin/env python
"""Offline per-op analysis of a jax.profiler trace + optimized-HLO sidecar.

Usage:
  python scripts/analyze_trace.py TRACE_DIR HLO_FILE [--top 30]

Aggregates the kernel time on the GPU device planes of the trace,
maps each instruction to its HLO op_name scope (which propagator family
/ engine phase it came from), and prints:
  - total device time and the FIXPOINT/SEARCH split,
  - top ops by device time with their scope,
  - time grouped by scope component (element / linear / member / groups
    / select / branch ...).

HLO_FILE is the optimized HLO of the traced program
(`compiled.as_text()`). Runs offline once the trace exists.
"""
from __future__ import annotations

import argparse
import collections
import glob
import sys
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from turbo_tpu.solver.profile_split import (  # noqa: E402
    _OPNAME_RE, _SUFFIX_RE, device_kernel_events, split)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("hlo_file")
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args()

    from jax.profiler import ProfileData

    with open(args.hlo_file) as f:
        hlo = f.read()

    opname = {}
    for line in hlo.splitlines():
        m = _OPNAME_RE.match(line)
        if m:
            opname[m.group(1)] = m.group(2)

    dur = collections.Counter()
    traces = [ProfileData.from_file(f) for f in glob.glob(
        args.trace_dir + "/**/*.xplane.pb", recursive=True)]
    planes = [p for t in traces for p in t.planes]
    for name, ns in device_kernel_events(planes):
        dur[name] += ns

    total = sum(dur.values())
    fix, other, unatt = split(planes, hlo)
    print(f"total device time  : {total/1e6:.2f} ms")
    print(f"fixpoint           : {fix/1e6:.2f} ms ({100.0*fix/max(total,1):.1f}%)")
    print(f"search/other       : {other/1e6:.2f} ms ({100.0*other/max(total,1):.1f}%)")
    print(f"unattributed       : {unatt/1e6:.2f} ms ({100.0*unatt/max(total,1):.1f}%)"
          "  (command_buffer events: trace with "
          "XLA_FLAGS=--xla_gpu_enable_command_buffer= to split them)")

    def scope_of(name):
        meta = opname.get(name) or opname.get(_SUFFIX_RE.sub("", name), "")
        return meta

    # Group by trailing scope path component sequence (drop the jit()/ prefix).
    by_scope = collections.Counter()
    for name, ns in dur.items():
        meta = scope_of(name)
        if meta:
            # keep the named_scope path, strip the op leaf
            parts = meta.split("/")
            # find segment after jit(...) wrappers
            segs = [p for p in parts if not p.startswith("jit(")]
            key = "/".join(segs[:-1]) or segs[-1]
        else:
            key = "<no-metadata>"
        by_scope[key] += ns
    print(f"\ntime by scope (top {args.top}):")
    for key, ns in by_scope.most_common(args.top):
        print(f"  {ns/1e6:10.2f} ms  {100.0*ns/max(total,1):5.1f}%  {key[:110]}")

    print(f"\ntop {args.top} individual ops:")
    for name, ns in dur.most_common(args.top):
        meta = scope_of(name)
        print(f"  {ns/1e6:10.2f} ms  {100.0*ns/max(total,1):5.1f}%  "
              f"{name[:44]:44s}  {meta[-70:]}")

    return 0


if __name__ == "__main__":
    sys.exit(main())
