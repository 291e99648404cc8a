"""3D CNN model zoo for voxel-wise synapse detection.

Parity: flypylib fplmodels (SURVEY.md section 2.2 row 2): a baseline stack
of valid 3D convolutions ending in a 1-channel output, a deeper VGG-like
variant, and a 3D U-Net variant.  Each zoo entry returns a ``ModelSpec``
carrying the module (:mod:`flypylib_tpu.models.layers`) together with its
exact receptive-field
``context`` — the voxels lost per face to valid convolution — which drives
all halo/stitching math (flypylib's ``(model, context)`` convention).

Design choices:

- NDHWC layout (channels last), DHWIO kernels.
- VALID padding everywhere: output = input - 2*context exactly, which makes
  overlap-tiled inference bitwise identical to monolithic inference
  (SURVEY.md section 7.3) — no SAME-padding border contamination.
- Receptive-field growth via kernel dilation instead of pooling in the
  plain stacks (keeps full-resolution voxel-wise output with static shapes
  and no upsampling), and a crop-and-concat valid U-Net for the
  encoder/decoder variant.
- bfloat16 compute / float32 params supported via the ``dtype`` argument;
  logits are always float32.

Models return logits; apply ``jax.nn.sigmoid`` for probabilities.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from flypylib_tpu.models.layers import (
    Module,
    batch_norm,
    conv,
    conv_transpose,
    max_pool,
)


@dataclass(frozen=True)
class ModelSpec:
    """A model plus the geometry facts the inference engine needs.

    - ``context``: voxels lost per face (isotropic int): output spatial size
      = input - 2*context.
    - ``size_multiple`` / ``size_offset``: valid input sizes are
      ``s = size_offset + k * size_multiple`` (pooling models constrain
      input sizes; plain conv stacks have multiple=1).
    - ``min_size``: smallest valid input size producing non-empty output.
    """

    name: str
    module: Module
    context: int
    size_multiple: int = 1
    size_offset: int = 0
    min_size: int = 0
    metadata: dict = field(default_factory=dict)

    def valid_size(self, s: int) -> int:
        """Smallest valid input size >= s (and >= min_size)."""
        s = max(int(s), self.min_size)
        if self.size_multiple == 1:
            return s
        rem = (s - self.size_offset) % self.size_multiple
        return s if rem == 0 else s + (self.size_multiple - rem)

    def is_valid_size(self, s: int) -> bool:
        return s >= self.min_size and (
            (s - self.size_offset) % self.size_multiple == 0
        )

    def init(self, key, patch_size: int | None = None):
        s = self.valid_size(patch_size if patch_size else self.min_size)
        x = jnp.zeros((1, s, s, s, 1), dtype=jnp.float32)
        return self.module.init(key, x, train=False)

    def apply(self, variables, x, train: bool = False, rngs=None, **kw):
        return self.module.apply(variables, x, train=train, rngs=rngs, **kw)


@dataclass(frozen=True)
class ConvStack(Module):
    """Plain valid-conv stack with optional dilation schedule.

    context = sum(dilation_i * (kernel - 1) // 2) over the 3^3 convs.
    """

    features: Sequence[int] = (24, 32, 48, 64)
    dilations: Sequence[int] = (1, 1, 2, 2)
    head_features: int = 96
    kernel: int = 3
    dtype: Any = jnp.bfloat16
    use_batchnorm: bool = False

    def forward(self, s, x, train: bool = False):
        x = x.astype(self.dtype)
        k = (self.kernel,) * 3
        for f, d in zip(self.features, self.dilations):
            x = conv(s, x, f, k, dilation=d, dtype=self.dtype)
            if self.use_batchnorm:
                x = batch_norm(s, x, train, dtype=self.dtype)
            x = jax.nn.relu(x)
        # 1x1x1 head (dense-equivalent, voxel-wise)
        x = jax.nn.relu(conv(s, x, self.head_features, (1, 1, 1),
                             dtype=self.dtype))
        logits = conv(s, x, 1, (1, 1, 1), dtype=jnp.float32)
        return logits.astype(jnp.float32)


@dataclass(frozen=True)
class UNetValid(Module):
    """3D U-Net with VALID convolutions and crop-and-concat skips.

    Original-U-Net-style valid tiling: every conv is valid, skips are
    center-cropped to match the upsampled decoder feature size, so the
    output is an exact center crop of the input — tiled inference stays
    bitwise exact.  Input sizes must satisfy a divisibility constraint
    (probed numerically; see ``unet``).
    """

    base_features: int = 24
    levels: int = 2
    convs_per_stage: int = 2
    dtype: Any = jnp.bfloat16

    def forward(self, s, x, train: bool = False):
        x = x.astype(self.dtype)
        k = (3, 3, 3)

        def block(x, feats):
            for _ in range(self.convs_per_stage):
                x = jax.nn.relu(conv(s, x, feats, k, dtype=self.dtype))
            return x

        skips = []
        feats = self.base_features
        for _ in range(self.levels):
            x = block(x, feats)
            skips.append(x)
            x = max_pool(x, 2)
            feats *= 2

        x = block(x, feats)

        for skip in reversed(skips):
            feats //= 2
            x = conv_transpose(s, x, feats, 2, dtype=self.dtype)
            # center-crop the skip to the upsampled size
            crops = [
                (skip.shape[i] - x.shape[i]) // 2 for i in (1, 2, 3)
            ]
            skip_c = skip[
                :,
                crops[0] : crops[0] + x.shape[1],
                crops[1] : crops[1] + x.shape[2],
                crops[2] : crops[2] + x.shape[3],
                :,
            ]
            x = jnp.concatenate([skip_c, x], axis=-1)
            x = block(x, feats)

        logits = conv(s, x, 1, (1, 1, 1), dtype=jnp.float32)
        return logits.astype(jnp.float32)


def _probe_geometry(module, lo: int = 8, hi: int = 120):
    """Numerically determine (context, size_multiple, size_offset, min_size)
    by shape-probing ``eval_shape`` over candidate input sizes."""
    def f(x):
        v = module.init(jax.random.PRNGKey(0), x, train=False)
        return module.apply(v, x, train=False)

    valid = []
    for s in range(lo, hi):
        try:
            out = jax.eval_shape(
                f, jax.ShapeDtypeStruct((1, s, s, s, 1), jnp.float32)
            )
        except Exception:
            continue
        o = out.shape[1]
        if o <= 0:
            continue
        if (s - o) % 2 == 0:
            valid.append((s, o))
    if not valid:
        raise ValueError("no valid input size found while probing model geometry")
    ctxs = {(s - o) // 2 for s, o in valid}
    # keep only sizes realizing the minimal (true) context: odd sizes through
    # floor-pooling can lose extra voxels
    ctx = min(ctxs)
    sizes = [s for s, o in valid if (s - o) // 2 == ctx]
    mult = 1 if len(sizes) < 2 else int(np.gcd.reduce(np.diff(sizes)))
    return ctx, mult, sizes[0] % mult if mult > 1 else 0, sizes[0]


def baseline_model(
    features=(24, 32, 48, 64),
    dilations=(1, 1, 2, 2),
    head_features: int = 96,
    dtype=jnp.bfloat16,
) -> ModelSpec:
    """Baseline voxel-wise 3D CNN (parity: flypylib fplmodels baseline).

    context = sum(dilations); receptive field = 2*context + 1 (13 voxels by
    default).
    """
    module = ConvStack(
        features=tuple(features),
        dilations=tuple(dilations),
        head_features=head_features,
        dtype=dtype,
    )
    ctx = sum(dilations)
    return ModelSpec(
        name="baseline",
        module=module,
        context=ctx,
        min_size=2 * ctx + 1,
        metadata={"features": tuple(features), "dilations": tuple(dilations)},
    )


def vgg_like(
    features=(32, 32, 48, 48, 64, 64, 96),
    dilations=(1, 1, 1, 2, 2, 4, 4),
    head_features: int = 128,
    dtype=jnp.bfloat16,
) -> ModelSpec:
    """Deeper VGG-style valid-conv stack (parity: flypylib fplmodels
    vgg-like variant).  Default receptive field = 31 voxels (context 15)."""
    module = ConvStack(
        features=tuple(features),
        dilations=tuple(dilations),
        head_features=head_features,
        dtype=dtype,
    )
    ctx = sum(dilations)
    return ModelSpec(
        name="vgg_like",
        module=module,
        context=ctx,
        min_size=2 * ctx + 1,
        metadata={"features": tuple(features), "dilations": tuple(dilations)},
    )


@functools.lru_cache(maxsize=8)
def _unet_geometry(base_features: int, levels: int, convs_per_stage: int):
    module = UNetValid(
        base_features=base_features,
        levels=levels,
        convs_per_stage=convs_per_stage,
    )
    return _probe_geometry(module)


def unet(base_features: int = 24, levels: int = 2, convs_per_stage: int = 2,
         dtype=jnp.bfloat16) -> ModelSpec:
    """Valid-conv 3D U-Net (parity: flypylib fplmodels U-Net variant,
    eval config 4 [B:10])."""
    module = UNetValid(
        base_features=base_features,
        levels=levels,
        convs_per_stage=convs_per_stage,
        dtype=dtype,
    )
    ctx, mult, off, min_size = _unet_geometry(base_features, levels, convs_per_stage)
    return ModelSpec(
        name="unet",
        module=module,
        context=ctx,
        size_multiple=mult,
        size_offset=off,
        min_size=min_size,
        metadata={
            "base_features": base_features,
            "levels": levels,
            "convs_per_stage": convs_per_stage,
        },
    )


MODEL_ZOO: dict[str, Callable[..., ModelSpec]] = {
    "baseline": baseline_model,
    "vgg_like": vgg_like,
    "unet": unet,
}
