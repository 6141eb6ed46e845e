"""turbo_tpu: a FlatZinc constraint solver in JAX.

A from-scratch reimplementation of the capabilities of ptal/turbo
(GPU propagate-and-search constraint solver): interval domains as
device-resident arrays, AC-1 propagation vectorized over
(dives x propagators), EPS dive-and-solve as a batched search VM,
incumbent sharing via an all-reduce across devices.
"""
__version__ = "0.1.0"

# The propagation kernels compute MUL/DIV deductions in int64 (domain
# bounds span +-2^30; products need 64 bits before clamping back).
# Everything else is explicitly typed int32.
import jax as _jax

_jax.config.update("jax_enable_x64", True)
