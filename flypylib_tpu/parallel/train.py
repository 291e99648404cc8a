"""Mesh data-parallel training.

Mesh replacement for flypylib multi_gpu.make_parallel (SURVEY.md
section 2.2 row 6): instead of replicating a Keras model under
``tf.device('/gpu:i')`` and slicing batches with Lambda layers, the jit'd
train step is pjit-partitioned over a ``Mesh``: params/opt-state
replicated, the on-device-sampled patch batch sharded over the ``data``
axis (``with_sharding_constraint``), and XLA inserts the gradient
all-reduce (psum) automatically.

The step body is exactly the single-chip one (flypylib_tpu.train.trainer
``make_step_impl``) with sharding callbacks — single-chip and multi-chip
training share semantics by construction (pinned by
tests/test_parallel.py: same seed -> same params).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flypylib_tpu.models.zoo import ModelSpec
from flypylib_tpu.train.trainer import TrainConfig, make_step_impl


def make_dp_train_step(
    spec: ModelSpec,
    cfg: TrainConfig,
    mesh: Mesh,
    data_axis: str = "data",
):
    """Build a mesh-data-parallel jit train step.

    ``cfg.batch_size`` is the GLOBAL batch; it must divide by the mesh's
    ``data`` axis size.  Returns ``(train_step, epoch_step, patch_size)``
    with signatures ``train_step(state, key, data) -> (state, metrics)``
    and ``epoch_step(state, keys, data)`` (scan over steps).
    """
    n_data = mesh.shape[data_axis]
    if cfg.batch_size % n_data != 0:
        raise ValueError(
            f"global batch {cfg.batch_size} not divisible by data axis {n_data}"
        )
    batch_sharding = NamedSharding(mesh, P(data_axis))
    repl = NamedSharding(mesh, P())

    def shard_batch(x):
        return jax.lax.with_sharding_constraint(x, batch_sharding)

    def shard_grads(grads):
        return jax.lax.with_sharding_constraint(
            grads, jax.tree.map(lambda _: repl, grads)
        )

    step_impl, patch = make_step_impl(
        spec, cfg, shard_batch=shard_batch, shard_grads=shard_grads
    )
    train_step = jax.jit(step_impl)

    @jax.jit
    def epoch_step(state, keys, data):
        def body(state, key):
            return step_impl(state, key, data)

        state, metrics = jax.lax.scan(body, state, keys)
        return state, jax.tree.map(lambda m: m.mean(), metrics)

    return train_step, epoch_step, patch
