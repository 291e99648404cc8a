"""Multi-process bring-up helpers.

Aux subsystem (SURVEY.md section 2.3, eval config 5 [B:11]): in a
multi-process job each process runs the same program;
``jax.distributed.initialize`` wires the processes together, after which
``jax.devices()`` spans every process's devices and the mesh/shard_map
code in this package runs unchanged (XLA hands the collectives to the
backend's communication library).

A single process (including the CPU test mesh) is a no-op, so library
code can call :func:`ensure_initialized` unconditionally.
"""

from __future__ import annotations

import logging
import os

import jax

logger = logging.getLogger("flypylib_tpu")

_initialized = False


def ensure_initialized(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed when running multi-process; no-op otherwise.

    The coordinator address, process count and process id come from
    the arguments, else from ``COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``; nothing is
    auto-detected.  Returns True if distributed mode is active.
    """
    global _initialized
    if _initialized:
        return True
    env_n = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    multi = (
        coordinator_address is not None
        or num_processes is not None
        or process_id is not None
        or os.environ.get("COORDINATOR_ADDRESS")
        or env_n > 1
    )
    if not multi:
        return False
    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = env_n
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    logger.info(
        "jax.distributed initialized: process %d/%d, %d devices",
        jax.process_index(), jax.process_count(), len(jax.devices()),
    )
    return True


def local_batch_size(global_batch: int) -> int:
    """Per-process batch for a globally-sharded batch axis."""
    n = jax.process_count()
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n} processes"
        )
    return global_batch // n
