"""FIXPOINT/SEARCH attribution of a device trace (statistics.hpp:83-130).

The reference brackets its solve phases with per-block device clocks
(TIMEPOINT, barebones_dive_and_solve.hpp:615-618). Our step is one
fused XLA program, so instead:

  1. the engine wraps propagation in ``jax.named_scope("fixpoint")`` -
     every HLO instruction born there carries
     ``metadata={op_name=".../fixpoint/..."}`` through XLA's pipeline
     (fusions inherit a representative constituent's op_name);
  2. this module sums the durations of the kernels on the GPU device
     planes (``/device:GPU:N``) of a ``jax.profiler`` trace and splits
     them by that scope marker (``scripts/analyze_trace.py``).

Each GPU kernel event carries the HLO instruction it was launched for
in its ``hlo_op`` stat; the event name itself is the kernel's name.
XLA runs the step's while loops as CUDA command buffers (graphs) by
default, and a whole captured region then shows as ONE event whose
``hlo_op`` is ``command_buffer``: it is reported as unattributed. A
per-kernel split needs a trace taken with command buffers off
(``XLA_FLAGS=--xla_gpu_enable_command_buffer=``), which changes what is
measured, so the solve loop does not trace itself; its timers keep the
regression fit of ``timers.PhaseTimers``.

Runtime instruction names can drift from ``compiled.as_text()`` names
by a numeric suffix (``fusion.3`` in text vs ``fusion.4`` at runtime),
so matching falls back from the exact instruction name to its
unsuffixed base when the base is unambiguous (all same-base
instructions on one side of the scope).
"""
from __future__ import annotations

import re
from typing import Iterable, Optional, Tuple

_OPNAME_RE = re.compile(
    r'^\s*(?:ROOT\s+)?%?([A-Za-z0-9_.\-]+)\s*=.*'
    r'metadata=\{[^}]*op_name="([^"]+)"')

_SUFFIX_RE = re.compile(r'(?:\.\d+|_\d+)+$')

# Timeline lines that a trace viewer derives from the kernel events;
# counting them beside the stream lines would count every kernel twice.
_DERIVED_LINES = ("XLA Modules", "XLA Ops", "Steps", "Framework Ops",
                  "Framework Name Scope", "Source code")


def event_instr_name(event_name: str) -> str:
    """Instruction name from a profiler event name ("%fusion.3 = s32[..]
    ..." or a bare "fusion.3"): the token before " = ", without the "%"
    sigil and any trailing type annotation after ":"."""
    head = event_name.split(" = ", 1)[0]
    return head.split(":")[0].strip().lstrip("%")


def hlo_scope_sets(hlo_text: str, scope: str = "fixpoint"):
    """Partition HLO instruction names by whether their op_name carries
    `scope`. Scans all computations (while bodies included). Returns
    (inside, outside, base_class) where base_class maps an unsuffixed
    base name to True (all inside), False (all outside) or None
    (ambiguous)."""
    inside, outside = set(), set()
    for line in hlo_text.splitlines():
        m = _OPNAME_RE.match(line)
        if not m:
            continue
        name, op_name = m.group(1), m.group(2)
        is_fix = f"/{scope}" in op_name or op_name.startswith(scope)
        (inside if is_fix else outside).add(name)
    base_class = {}
    for name in inside:
        base_class[_SUFFIX_RE.sub("", name)] = True
    for name in outside:
        b = _SUFFIX_RE.sub("", name)
        base_class[b] = None if base_class.get(b) is True else False
    return inside, outside, base_class


def classify(name: str, inside, outside, base_class) -> Optional[bool]:
    """True=fixpoint, False=other, None=unattributable."""
    if name in inside:
        return True
    if name in outside:
        return False
    return base_class.get(_SUFFIX_RE.sub("", name))


def device_kernel_events(planes: Iterable):
    """(hlo instruction name, duration ns) of every kernel event on the
    GPU device planes of a trace. `planes` are ProfileData planes (or
    any objects with the same name/lines/events/stats attributes)."""
    for plane in planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name in _DERIVED_LINES:
                continue
            for e in line.events:
                if e.duration_ns <= 0:
                    continue
                op = dict(e.stats).get("hlo_op")
                if op is None:
                    continue  # memcpy/memset and runtime activity
                yield event_instr_name(str(op)), e.duration_ns


def split(planes: Iterable, hlo_text: str) -> Tuple[int, int, int]:
    """(fixpoint ns, other ns, unattributed ns) of the kernel time on
    the GPU device planes of a trace, against the optimized HLO text of
    the traced program."""
    inside, outside, base_class = hlo_scope_sets(hlo_text)
    out = [0, 0, 0]
    for name, dur in device_kernel_events(planes):
        cls = classify(name, inside, outside, base_class)
        out[0 if cls is True else 1 if cls is False else 2] += dur
    return out[0], out[1], out[2]
