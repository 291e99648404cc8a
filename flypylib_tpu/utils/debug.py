"""Debug / sanitizer toggles.

Aux subsystem (SURVEY.md section 5, race detection/sanitizers row): JAX's
functional model removes data races by construction; the remaining failure
modes are numeric (NaN/Inf) and shape/recompile surprises.  These helpers
wire up jax's debug machinery in one call for CI debug jobs:

- NaN/Inf checking on every jit output (``jax_debug_nans`` /
  ``jax_debug_infs``) — failing dispatch re-runs op-by-op and points at
  the producing primitive;
- disable jit entirely for pdb-able eager execution;
- recompile logging to catch silent shape-driven recompilation.
"""

from __future__ import annotations

import contextlib
import logging

import jax

logger = logging.getLogger("flypylib_tpu")


def enable_nan_checks(infs: bool = True) -> None:
    jax.config.update("jax_debug_nans", True)
    if infs:
        jax.config.update("jax_debug_infs", True)


def disable_nan_checks() -> None:
    jax.config.update("jax_debug_nans", False)
    jax.config.update("jax_debug_infs", False)


@contextlib.contextmanager
def nan_checks():
    """Context manager form of NaN/Inf checking."""
    enable_nan_checks()
    try:
        yield
    finally:
        disable_nan_checks()


@contextlib.contextmanager
def eager_mode():
    """Disable jit inside the context (pdb-able, slow)."""
    with jax.disable_jit():
        yield


def log_recompiles(enable: bool = True) -> None:
    """Log every XLA compilation — catches accidental shape churn."""
    jax.config.update("jax_log_compiles", enable)
