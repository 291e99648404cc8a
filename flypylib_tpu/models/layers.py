"""A minimal module layer on ``jax.lax``: Conv, ConvTranspose, BatchNorm,
max-pool, and the ``init``/``apply`` protocol the zoo models expose.

The variables tree follows the auto-naming convention the checkpoints,
the Keras importer and the packed engines key on: per layer kind a
counter in call order (``Conv_0``, ``Conv_1``, ``ConvTranspose_0``,
``BatchNorm_0``), parameters under ``params/<layer>/{kernel,bias}`` or
``{scale,bias}``, running statistics under
``batch_stats/<layer>/{mean,var}``.  Conv kernels are DHWIO.

A model subclasses :class:`Module` (a frozen dataclass, so it hashes by
value and can key geometry caches) and implements
``forward(scope, x, train)`` by calling the layer functions below with
the :class:`Scope` it is given.

- ``init(key, x, train=False)`` runs ``forward`` once, creating every
  parameter (kernels LeCun-normal, biases and BN shifts zero, BN scales
  and variances one) and returns ``{"params": ..., "batch_stats": ...}``
  (``batch_stats`` only when the model has BatchNorm).  The i-th
  parameter of layer ``L`` (1-based, in creation order) draws from
  ``fold_in(key, sha1(L, i))`` — the derivation Flax uses — so a seed
  gives the same weights the earlier Flax definitions gave.
- ``apply(variables, x, train=False, rngs=None, mutable=False)`` returns
  the output, or ``(output, updates)`` when ``mutable`` is given; with
  ``"batch_stats"`` in ``mutable`` and ``train=True`` the updates hold
  the new running statistics.

Arithmetic: inputs, kernels and biases are cast to the layer ``dtype``
before the convolution (bf16 operands, accumulation left to the
backend), the bias is added in that dtype; BatchNorm reduces in float32
with ``var = E[x^2] - E[x]^2`` clipped at 0, ``momentum=0.99``,
``epsilon=1e-5``.
"""

from __future__ import annotations

import hashlib
from collections import Counter
from dataclasses import dataclass
from typing import Any, Sequence

import jax
import jax.numpy as jnp
from jax import lax

_DIMS = ("NDHWC", "DHWIO", "NDHWC")
_lecun_normal = jax.nn.initializers.lecun_normal()

BN_MOMENTUM = 0.99
BN_EPSILON = 1e-5


def _param_key(key, layer: str, i: int):
    """Key of the ``i``-th parameter of ``layer``: the first 4 bytes
    of SHA-1(layer name, i) folded into ``key`` (Flax's scheme)."""
    m = hashlib.sha1(layer.encode("utf-8"))
    m.update(i.to_bytes((i.bit_length() + 7) // 8, byteorder="big"))
    h = int.from_bytes(m.digest()[:4], byteorder="big")
    return jax.random.fold_in(key, jnp.uint32(h))


class Scope:
    """Variable access for one ``init`` or ``apply`` pass.

    ``key`` set means initializing: parameters are created on first
    access (each from :func:`_param_key`) and running statistics are not
    updated."""

    def __init__(self, variables=None, key=None):
        variables = variables or {}
        self.key = key
        self.params = {k: dict(v) for k, v in variables.get("params", {}).items()}
        self.stats = {
            k: dict(v) for k, v in variables.get("batch_stats", {}).items()
        }
        self.new_stats: dict = {}
        self._counts: Counter = Counter()
        self._n_params: Counter = Counter()

    @property
    def initializing(self) -> bool:
        return self.key is not None

    def name(self, kind: str) -> str:
        i = self._counts[kind]
        self._counts[kind] += 1
        return f"{kind}_{i}"

    def _get(self, tree, layer, leaf, make):
        group = tree.setdefault(layer, {}) if self.initializing else tree[layer]
        if leaf not in group:
            if not self.initializing:
                raise KeyError(f"missing variable {layer}/{leaf}")
            group[leaf] = make()
        return group[leaf]

    def param(self, layer, leaf, init_fn, shape):
        def make():
            self._n_params[layer] += 1
            key = _param_key(self.key, layer, self._n_params[layer])
            return init_fn(key, shape, jnp.float32)

        return self._get(self.params, layer, leaf, make)

    def stat(self, layer, leaf, init_fn, shape):
        return self._get(
            self.stats, layer, leaf, lambda: init_fn(shape, jnp.float32)
        )

    def variables(self) -> dict:
        out = {"params": self.params}
        if self.stats:
            out["batch_stats"] = self.stats
        return out


@dataclass(frozen=True)
class Module:
    """Base for the zoo models: subclasses implement ``forward``."""

    def forward(self, scope: Scope, x, train: bool):
        raise NotImplementedError

    def init(self, key, x, train: bool = False) -> dict:
        scope = Scope(key=key)
        self.forward(scope, x, train)
        return scope.variables()

    def apply(self, variables, x, train: bool = False, rngs=None,
              mutable=False):
        scope = Scope(variables)
        out = self.forward(scope, x, train)
        if mutable is False or mutable is None:
            return out
        names = [mutable] if isinstance(mutable, str) else list(mutable)
        updates = {}
        if "batch_stats" in names and scope.new_stats:
            updates["batch_stats"] = {**scope.stats, **scope.new_stats}
        return out, updates


def conv(scope: Scope, x, features: int, kernel_size: Sequence[int],
         dilation: int = 1, dtype: Any = jnp.float32):
    """Valid 3-D convolution + bias (``Conv_i``), NDHWC x DHWIO."""
    name = scope.name("Conv")
    kshape = tuple(kernel_size) + (x.shape[-1], features)
    kernel = scope.param(name, "kernel", _lecun_normal, kshape)
    bias = scope.param(name, "bias", jax.nn.initializers.zeros, (features,))
    y = lax.conv_general_dilated(
        x.astype(dtype), kernel.astype(dtype), (1, 1, 1), "VALID",
        lhs_dilation=(1, 1, 1), rhs_dilation=(dilation,) * 3,
        dimension_numbers=_DIMS,
    )
    return y + bias.astype(dtype).reshape((1,) * 4 + (-1,))


def conv_transpose(scope: Scope, x, features: int, size: int = 2,
                   dtype: Any = jnp.float32):
    """Kernel-``size`` stride-``size`` transposed convolution + bias
    (``ConvTranspose_i``): ``lax.conv_transpose`` with SAME padding and
    an unflipped DHWIO kernel, so for size 2 output voxel ``2r + p``
    reads ``x[r] @ K[1 - p]``."""
    name = scope.name("ConvTranspose")
    kshape = (size,) * 3 + (x.shape[-1], features)
    kernel = scope.param(name, "kernel", _lecun_normal, kshape)
    bias = scope.param(name, "bias", jax.nn.initializers.zeros, (features,))
    y = lax.conv_transpose(
        x.astype(dtype), kernel.astype(dtype), (size,) * 3, "SAME",
        rhs_dilation=(1, 1, 1), transpose_kernel=False,
    )
    return y + bias.astype(dtype).reshape((1,) * 4 + (-1,))


def batch_norm(scope: Scope, x, train: bool, dtype: Any = jnp.float32):
    """BatchNorm over every axis but the last (``BatchNorm_i``).

    ``train=True`` normalizes with the batch statistics and, outside
    ``init``, records the new running averages for ``apply(mutable=)``;
    ``train=False`` uses the running averages."""
    name = scope.name("BatchNorm")
    feat = (x.shape[-1],)
    ra_mean = scope.stat(name, "mean", jnp.zeros, feat)
    ra_var = scope.stat(name, "var", jnp.ones, feat)
    axes = tuple(range(x.ndim - 1))
    if train:
        xf = x.astype(jnp.float32)
        mean = xf.mean(axes)
        var = jnp.maximum(0.0, lax.square(xf).mean(axes) - lax.square(mean))
        if not scope.initializing:
            scope.new_stats[name] = {
                "mean": BN_MOMENTUM * ra_mean + (1 - BN_MOMENTUM) * mean,
                "var": BN_MOMENTUM * ra_var + (1 - BN_MOMENTUM) * var,
            }
    else:
        mean, var = ra_mean, ra_var
    scale = scope.param(name, "scale", jax.nn.initializers.ones, feat)
    bias = scope.param(name, "bias", jax.nn.initializers.zeros, feat)
    y = x - mean
    y = y * (lax.rsqrt(var + BN_EPSILON) * scale)
    y = y + bias
    return jnp.asarray(y, dtype)


def max_pool(x, size: int = 2):
    """``size``^3 max-pool, stride ``size``, VALID."""
    return lax.reduce_window(
        x, -jnp.inf, lax.max, (1,) + (size,) * 3 + (1,),
        (1,) + (size,) * 3 + (1,), "VALID",
    )
