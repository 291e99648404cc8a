"""Space-to-depth packed inference engine for ConvStack models.

The baseline stack's convolutions are narrow (24-64 channels); this
engine widens them by a graph-level layout rewrite, not a hand kernel.
It was built for a matrix unit that ran narrow convs far below its peak;
whether it beats the plain module on the GPU is measured per cell
(``FplNetwork(packed=)``, ``TrainConfig(engine=)``).

- **Dilation-1 layers — space-to-depth channel packing.**  The volume is
  packed 2x2x2 -> 8 channels; a valid 3^3 conv becomes a valid 2^3 conv
  with 8x the channels (the 2^3 x 8 = 64-slot packed kernel embeds the 27
  taps, 2.37x redundant FLOPs).
- **Dilation-2^k layers — parity-lattice batching.**  A dilation-d conv
  only connects voxels of equal coordinates mod d.  On the packed tensor
  the 8 parity channel groups ARE the d=2 sub-lattices, so a dilation-2
  layer is exactly a batch of 8 dilation-1 convs on half-resolution
  lattices; dilation-4 splits
  parities once more (batch 64), etc.

All rewrites are exact re-associations of the same multiply-adds (packed
kernels embed the original taps; extra slots are zeros), so outputs match
``ConvStack.apply`` to bf16-accumulation tolerance; tests pin this
(tests/test_packed_conv.py).  Because packing is phase-dependent, a packed
model's ``size_multiple`` is 2^(1+extra splits) and tile starts must align
to it — ``packed_spec`` probes the exact geometry numerically and exports
a drop-in :class:`~flypylib_tpu.models.zoo.ModelSpec`, so TiledInference /
DetectPipeline / sharded_infer work unchanged (and stay bitwise
self-consistent tiled vs monolithic).

``apply(train=True)`` delegates to the inner module (one params tree for
checkpoints and Keras import); :meth:`PackedConvStack.forward_train` is
the differentiable packed forward the packed train engine runs.
"""

from __future__ import annotations

import functools
from itertools import product

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from flypylib_tpu.models.zoo import ConvStack, ModelSpec, _probe_geometry

_PARITY = list(product(range(2), repeat=3))  # (pz, py, px), px fastest


def _pack_volume_impl(x: jax.Array) -> jax.Array:
    b, d, h, w, c = x.shape
    if d % 2 or h % 2 or w % 2:
        raise ValueError(f"pack_volume needs even spatial dims, got {x.shape}")
    x = x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)
    x = x.transpose(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, d // 2, h // 2, w // 2, 8 * c)


def _unpack_volume_impl(x: jax.Array) -> jax.Array:
    b, d, h, w, c8 = x.shape
    c = c8 // 8
    x = x.reshape(b, d, h, w, 2, 2, 2, c)
    x = x.transpose(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, 2 * d, 2 * h, 2 * w, c)


def _pack_volume_iv_impl(x: jax.Array) -> jax.Array:
    b, d, h, w, c = x.shape
    if d % 2 or h % 2 or w % 2:
        raise ValueError(f"pack_volume needs even spatial dims, got {x.shape}")
    # x-parity is adjacent to w in row-major: split-merge into channel
    x = x.reshape(b, d, h, w // 2, 2 * c)
    # y-parity / z-parity: strided cell slices + channel concat
    x = jnp.concatenate((x[:, :, 0::2], x[:, :, 1::2]), axis=-1)
    return jnp.concatenate((x[:, 0::2], x[:, 1::2]), axis=-1)


def _unpack_volume_iv_impl(x: jax.Array) -> jax.Array:
    b, d, h, w, c8 = x.shape
    c = c8 // 8
    # z: channel halves are z-parity 0/1 (packed index (pz, py, px, ch))
    x = jnp.stack((x[..., : c8 // 2], x[..., c8 // 2 :]), axis=2)
    x = x.reshape(b, 2 * d, h, w, c8 // 2)
    x = jnp.stack((x[..., : c8 // 4], x[..., c8 // 4 :]), axis=3)
    x = x.reshape(b, 2 * d, 2 * h, w, c8 // 4)
    # x-parity is adjacent to w after the channel split: merge-reshape
    return x.reshape(b, 2 * d, 2 * h, 2 * w, c)


# Hand-written VJPs.  pack/unpack are inverse
# PERMUTATIONS of the same elements, so the cotangent of one is exactly
# the other applied to the incoming cotangent — bitwise, not just
# mathematically.  Routing every backward through the *_iv interleave
# forms avoids the cotangent graphs XLA derives on its own (the strided
# slices in pack_volume_iv transpose to interior-padded pads that are
# then summed — full-size padded temps per axis; the 8-D transpose
# forms relayout-copy at training shapes).

def _mk_pack_vjp(fwd_impl, bwd_impl):
    f = jax.custom_vjp(fwd_impl)
    f.defvjp(lambda x: (fwd_impl(x), None),
             lambda _, g: (bwd_impl(g),))
    return f


pack_volume = _mk_pack_vjp(_pack_volume_impl, _unpack_volume_iv_impl)
pack_volume.__name__ = "pack_volume"
pack_volume.__doc__ = """(B, D, H, W, C) -> (B, D/2, H/2, W/2, 8C); dims must be even.

    Packed channel index = ((pz*2 + py)*2 + px)*C + c, i.e. cell (r) /
    parity (p) encode original position 2r + p per axis.  Backward is
    the hand-written inverse permutation (interleave form) — see
    module comment above :func:`_mk_pack_vjp`.
    """

unpack_volume = _mk_pack_vjp(_unpack_volume_impl, _pack_volume_iv_impl)
unpack_volume.__name__ = "unpack_volume"
unpack_volume.__doc__ = """Inverse of :func:`pack_volume` (hand-written VJP, see above)."""

pack_volume_iv = _mk_pack_vjp(_pack_volume_iv_impl, _unpack_volume_iv_impl)
pack_volume_iv.__name__ = "pack_volume_iv"
pack_volume_iv.__doc__ = """:func:`pack_volume` by three per-axis de-interleaves (split-
    reshape + strided slices with channel concat) instead of one 8-D
    transpose.  Bitwise the same values; the transpose form can make
    XLA's layout assignment copy the whole tile into a padded layout,
    this form cannot.  Use for big-spatial packs (the U-Net
    covering tiles); small tiles are fine either way.
    Backward is the hand-written de-interleave (see _mk_pack_vjp)."""

unpack_volume_iv = _mk_pack_vjp(_unpack_volume_iv_impl, _pack_volume_iv_impl)
unpack_volume_iv.__name__ = "unpack_volume_iv"
unpack_volume_iv.__doc__ = """:func:`unpack_volume` by three per-axis channel-split interleaves
    (stack + merge-reshape) instead of one 8-D transpose.

    Bitwise the same values.  The one-shot transpose form let the first
    platform's layout assignment materialize the (..., 2, 2, 2, c)
    parity view with the size-2 parity dims minor — padded 64x, a
    multi-GB temp on 300^3-class tiles.  The per-axis stacks keep a wide
    channel dim minor at every step, so each materialization is an
    unpadded copy.  Backward is the
    hand-written interleave (see _mk_pack_vjp)."""


@functools.lru_cache(maxsize=4)
def _tap_matrix() -> np.ndarray:
    """A[t, u, s, k] = 1 iff 2t + u - s == k (per-axis packed-tap map)."""
    a = np.zeros((2, 2, 2, 3), np.float32)
    for t, u, s in product(range(2), repeat=3):
        k = 2 * t + u - s
        if 0 <= k <= 2:
            a[t, u, s, k] = 1.0
    return a


def pack_weight_d1(w: jax.Array) -> jax.Array:
    """(3,3,3,Ci,Co) valid-conv kernel -> (2,2,2,8Ci,8Co) packed kernel.

    Derivation: y[2r+s] = sum_delta w[delta] x[2r+s+delta]; writing
    s+delta = 2t+u gives the packed tap (t) / input-parity (u) /
    output-parity (s) map encoded by :func:`_tap_matrix`.  Slots with no
    corresponding original tap are zero (the 2.37x FLOP redundancy).
    """
    kz, ky, kx, ci, co = w.shape
    assert (kz, ky, kx) == (3, 3, 3)
    a = jnp.asarray(_tap_matrix(), w.dtype)
    # out[tz,ty,tx, uz,uy,ux, ci, sz,sy,sx, co]
    wp = jnp.einsum(
        "adgz,behy,cfix,zyxmo->abcdefmghio",
        a, a, a, w,
    )
    return wp.reshape(2, 2, 2, 8 * ci, 8 * co)


def _parity_split_impl(x: jax.Array) -> jax.Array:
    b, d, h, w, c = x.shape
    if d % 2 or h % 2 or w % 2:
        raise ValueError(
            f"parity_split needs even spatial dims, got {x.shape}"
        )
    x = x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)
    x = x.transpose(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b * 8, d // 2, h // 2, w // 2, c)


def _parity_merge_impl(x: jax.Array) -> jax.Array:
    b8, d, h, w, c = x.shape
    b = b8 // 8
    x = x.reshape(b, 2, 2, 2, d, h, w, c)
    x = x.transpose(0, 4, 1, 5, 2, 6, 3, 7)
    return x.reshape(b, 2 * d, 2 * h, 2 * w, c)


def _mk_parity_vjp(fwd_impl, bwd_impl):
    """custom_vjp whose backward is the hand-written inverse permutation
    BEHIND an optimization_barrier, mirroring the forward chain's
    barrier (which keeps XLA from fusing the parity-split transpose into
    the first stage-B conv)."""
    f = jax.custom_vjp(fwd_impl)
    f.defvjp(lambda x: (fwd_impl(x), None),
             lambda _, g: (lax.optimization_barrier(bwd_impl(g)),))
    return f


parity_split = _mk_parity_vjp(_parity_split_impl, _parity_merge_impl)
parity_split.__name__ = "parity_split"
parity_split.__doc__ = """(B, D, H, W, C) -> (8B, D/2, H/2, W/2, C): batch the 8 parity
    sub-lattices (new batch = b*8 + ((pz*2+py)*2+px)); dims must be even.
    Backward is the barrier'd hand-written merge (see _mk_parity_vjp)."""

parity_merge = _mk_parity_vjp(_parity_merge_impl, _parity_split_impl)
parity_merge.__name__ = "parity_merge"
parity_merge.__doc__ = """Inverse of :func:`parity_split` (barrier'd hand-written VJP)."""


def _parity_batch_impl(x: jax.Array) -> jax.Array:
    b0, d, h, w_, c8 = x.shape
    c = c8 // 8
    x = x.reshape(b0, d, h, w_, 8, c)
    return x.transpose(0, 4, 1, 2, 3, 5).reshape(b0 * 8, d, h, w_, c)


def _parity_unbatch_impl(x: jax.Array) -> jax.Array:
    b8, d, h, w_, c = x.shape
    b0 = b8 // 8
    x = x.reshape(b0, 8, d, h, w_, c)
    return x.transpose(0, 2, 3, 4, 1, 5).reshape(b0, d, h, w_, 8 * c)


parity_batch = _mk_parity_vjp(_parity_batch_impl, _parity_unbatch_impl)
parity_batch.__name__ = "parity_batch"
parity_batch.__doc__ = """Packed parity-major channels -> parity-batched lattices:
    (B, d, h, w, 8c) -> (8B, d, h, w, c) with new batch b*8 + parity.
    The stage-A/stage-B boundary relayout, as a named op so its backward
    is the barrier'd hand-written inverse (see _mk_parity_vjp)."""


def _conv(x, w, dims=("NDHWC", "DHWIO", "NDHWC")):
    # No preferred_element_type: the convolution accumulates in f32
    # internally, but the output rounds straight to the compute dtype —
    # exactly models.layers.conv's dataflow, and half the device memory
    # for bf16 activation temps.
    return lax.conv_general_dilated(
        x, w, (1, 1, 1), "VALID", dimension_numbers=dims,
    )


class PackedConvStack:
    """Duck-typed inference module running a ConvStack in packed layout.

    Drop-in for ``ModelSpec.module``: exposes ``init`` (delegates to the
    inner module — ONE params tree for both paths) and ``apply``
    (packed fast path for ``train=False``, inner module for training).
    """

    def __init__(self, inner: ConvStack, stage_b: str = "split"):
        if inner.kernel != 3:
            raise ValueError("packed path supports kernel=3 only")
        dils = [int(d) for d in inner.dilations]
        for i, d in enumerate(dils):
            if d & (d - 1):
                raise ValueError(f"dilation {d} is not a power of two")
            if i and d < dils[i - 1]:
                raise ValueError(
                    f"dilation schedule {dils} must be non-decreasing"
                )
        if stage_b not in ("group", "split"):
            raise ValueError(f"unknown stage_b {stage_b!r}")
        self.inner = inner
        self.dilations = dils
        self.n_lead = next(
            (i for i, d in enumerate(dils) if d > 1), len(dils)
        )
        # "split" (default): the parity-batched formulation.  "group"
        # keeps the dilated layers in the PACKED domain as feature-group
        # convs (the 8 parity groups are the groups; a dilation-d conv
        # only connects equal-parity voxels, so cell dilation d/2 per
        # group is exact) — exact, looser size constraints
        # (size_multiple stays 2 even with dilation 4), but
        # not the default: feature-group convs lowered poorly on the
        # first platform (not yet measured on the GPU).  Kept for A/B
        # and for dilation-4 models that need the looser alignment.
        self.stage_b = stage_b if self.n_lead else "split"
        self.dtype = inner.dtype

    # --- ModelSpec protocol -------------------------------------------
    def init(self, key, x, train: bool = False):
        return self.inner.init(key, x, train=train)

    def apply(self, variables, x, train: bool = False, rngs=None, **kw):
        if train or kw.get("mutable"):
            return self.inner.apply(
                variables, x, train=train, rngs=rngs, **kw
            )
        return self._forward(variables, x)

    # --- packed forward ------------------------------------------------
    def _affine(self, variables, idx):
        """Inference-mode BatchNorm as a per-channel (scale, shift)."""
        p = variables["params"][f"BatchNorm_{idx}"]
        s = variables["batch_stats"][f"BatchNorm_{idx}"]
        inv = lax.rsqrt(s["var"].astype(jnp.float32) + 1e-5)
        scale = p["scale"].astype(jnp.float32) * inv
        shift = (
            p["bias"].astype(jnp.float32)
            - s["mean"].astype(jnp.float32) * scale
        )
        return scale, shift

    def _forward(self, variables, x):
        if self.n_lead and self.stage_b == "group":
            params = variables["params"]
            dt = self.dtype
            x = x.astype(dt)
            x = pack_volume(x)
            for i in range(self.n_lead):
                w = params[f"Conv_{i}"]["kernel"].astype(dt)
                x = _conv(x, pack_weight_d1(w))
                x = self._epilogue(variables, x, i, dt)
            return self._stage_b_group(variables, x, params, dt)
        return self.apply_stage_b(
            variables, self.apply_stage_a(variables, x)
        )

    # --- two-phase protocol -------------------------------------------
    # The packed forward split at the parity-split boundary.  Composing
    # the phases in ONE jit reproduces the monolithic forward exactly
    # (the phase boundary is where _forward's optimization_barrier sat);
    # running them as SEPARATE dispatches removed a scheduling pathology
    # of the first platform's compiler that the barrier only partially
    # fixed — DetectPipeline can run each slab as phase-A + phase-B
    # dispatches (``two_phase``; not yet A/B'd on the GPU).

    def apply_stage_a(self, variables, x):
        """Phase 1: cast + pack + stage-A packed convs + parity split.

        Returns the parity-batched stage-B input (``(8B, d, h, w, c)``;
        the plain casted tensor when the model has no dilation-1 lead).
        Ends with an optimization_barrier so in-jit composition keeps
        the materialized-split fix."""
        params = variables["params"]
        dt = self.dtype
        x = x.astype(dt)
        if not self.n_lead:
            return x
        x = pack_volume(x)
        for i in range(self.n_lead):
            w = params[f"Conv_{i}"]["kernel"].astype(dt)
            x = _conv(x, pack_weight_d1(w))
            x = self._epilogue(variables, x, i, dt)
        # packed channels (parity-major) -> parity-batched lattices
        x = parity_batch(x)
        return lax.optimization_barrier(x)

    def apply_stage_b(self, variables, x, *, f32_logits: bool = False):
        """Phase 2: dilated stage-B convs (parity-batched lattices) +
        head + logits + parity merge back to full resolution.

        ``f32_logits`` swaps the split-weight bf16 logits conv for the
        plain f32 conv: the split-weight form's mixed-dtype conv
        (bf16 operands, f32 ``preferred_element_type``) has no JAX
        transpose rule, so the differentiable path
        (:meth:`forward_train`) needs the f32 form — a pure-bandwidth
        cost that is negligible at training patch sizes."""
        inner = self.inner
        params = variables["params"]
        dt = self.dtype
        n_body = len(inner.features)
        level = 1 if self.n_lead else 0

        # stage B: dilated layers as dilation-1 convs on parity lattices
        for i in range(self.n_lead, n_body):
            d = self.dilations[i]
            while (1 << level) < d:
                x = parity_split(x)
                level += 1
            if (1 << level) != d:
                raise ValueError(
                    f"dilation {d} below current lattice step {1 << level}"
                )
            w = params[f"Conv_{i}"]["kernel"].astype(dt)
            x = _conv(x, w)
            x = self._epilogue(variables, x, i, dt, tile=1)

        # head 1x1x1 conv + relu (pointwise: parity-independent)
        w = params[f"Conv_{n_body}"]["kernel"].astype(dt)
        b = params[f"Conv_{n_body}"]["bias"].astype(dt)
        x = _conv(x, w).astype(dt) + b
        x = jax.nn.relu(x)

        if f32_logits:
            w = params[f"Conv_{n_body + 1}"]["kernel"].astype(jnp.float32)
            b = params[f"Conv_{n_body + 1}"]["bias"].astype(jnp.float32)
            x = _conv(x.astype(jnp.float32), w) + b
        else:
            x = self._logits_split_weight(x, params, dt)

        # merge parity lattices back to full resolution
        for _ in range(level):
            x = parity_merge(x)
        return x

    def forward_train(self, variables, x):
        """Differentiable packed forward (same re-association as
        :meth:`_forward`, f32 logits conv — see ``f32_logits``).

        Valid as a TRAINING computation on the shared params tree when
        the model has no BatchNorm (the packed epilogue folds running
        stats, which is inference-mode semantics).  The space-to-depth
        rewrite is an exact linear re-association, so its
        ``value_and_grad`` optimizes the same objective as the plain
        forward up to bf16 rounding."""
        if self.inner.use_batchnorm:
            raise ValueError(
                "packed training requires use_batchnorm=False (the "
                "packed epilogue folds inference-mode running stats)"
            )
        if self.n_lead and self.stage_b == "group":
            raise ValueError("packed training supports stage_b='split'")
        return self.apply_stage_b(
            variables, self.apply_stage_a(variables, x), f32_logits=True
        )

    def _logits_split_weight(self, x, params, dt, groups: int = 1):
        """Logits conv: ConvStack's head is f32, but upcasting the
        96-channel activation to f32 is pure HBM bandwidth (bf16->f32
        is value-exact, so the f32 conv gains nothing from the input
        side).  Split the f32 weight into two bf16 terms (w = hi + lo,
        ~16 mantissa bits) stacked on the output channel, run ONE bf16
        conv with f32 accumulation, and sum — ~1e-6 relative error vs
        the f32 conv, far inside the engine's bf16-parity tolerance.

        ``groups`` > 1 runs the (parity-independent) 1x1 conv per parity
        group of a packed tensor; output is (..., groups) logits."""
        n_body = len(self.inner.features)
        w = params[f"Conv_{n_body + 1}"]["kernel"].astype(jnp.float32)
        b = params[f"Conv_{n_body + 1}"]["bias"].astype(jnp.float32)
        w_hi = w.astype(dt)
        w_lo = (w - w_hi.astype(jnp.float32)).astype(dt)
        wcat = jnp.concatenate([w_hi, w_lo], axis=-1)
        if groups > 1:
            wcat = jnp.tile(wcat, (1, 1, 1, 1, groups))
        y = lax.conv_general_dilated(
            x.astype(dt), wcat, (1, 1, 1), "VALID",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            feature_group_count=groups,
            preferred_element_type=jnp.float32,
        )
        co = w.shape[-1]  # logits channels (1)
        if groups > 1:
            y = y.reshape(*y.shape[:-1], groups, 2 * co)
            return y[..., :co] + y[..., co:] + b  # (..., groups, co)
        return y[..., :co] + y[..., co:] + b

    def _stage_b_group(self, variables, x, params, dt):
        """Stage B + head + logits entirely in the PACKED domain.

        A dilation-d conv (d = 2^k >= 2) connects voxels of equal
        coordinates mod 2, i.e. within one parity group of the packed
        tensor; on the cell lattice its taps step d/2 cells.  So each
        dilated 3^3 layer is ONE feature-group conv (groups = the 8
        parity channel groups, kernel tiled per group, rhs_dilation
        d/2) — no parity_split relayout, no batch blow-up; the grouped
        form runs the same FLOPs straight off the packed layout.
        """
        n_body = len(self.inner.features)
        for i in range(self.n_lead, n_body):
            d = self.dilations[i]
            w = params[f"Conv_{i}"]["kernel"].astype(dt)
            x = lax.conv_general_dilated(
                x, jnp.tile(w, (1, 1, 1, 1, 8)), (1, 1, 1), "VALID",
                rhs_dilation=(d // 2,) * 3,
                dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
                feature_group_count=8,
            )
            x = self._epilogue(variables, x, i, dt)

        # head 1x1x1 conv + relu per parity group
        w = params[f"Conv_{n_body}"]["kernel"].astype(dt)
        b = params[f"Conv_{n_body}"]["bias"].astype(dt)
        x = lax.conv_general_dilated(
            x, jnp.tile(w, (1, 1, 1, 1, 8)), (1, 1, 1), "VALID",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            feature_group_count=8,
        ).astype(dt) + jnp.tile(b, 8)
        x = jax.nn.relu(x)

        y = self._logits_split_weight(x, params, dt, groups=8)
        # (..., 8, co): parity-major groups -> full resolution
        return unpack_volume(y.reshape(*y.shape[:-2], 8 * y.shape[-1]))

    def _epilogue(self, variables, y, i, dt, tile: int = 8):
        """bias (+ BatchNorm) + ReLU with channel params tiled per
        parity group (packed-domain epilogue)."""
        params = variables["params"]
        b = params[f"Conv_{i}"]["bias"].astype(dt)
        y = y + jnp.tile(b, tile)
        if self.inner.use_batchnorm:
            scale, shift = self._affine(variables, i)
            y = (
                y * jnp.tile(scale.astype(dt), tile)
                + jnp.tile(shift.astype(dt), tile)
            )
        return jax.nn.relu(y)

    def __repr__(self):
        return f"PackedConvStack({self.inner!r})"


@functools.lru_cache(maxsize=16)
def _packed_geometry(module: ConvStack, stage_b: str):
    pm = PackedConvStack(module, stage_b=stage_b)
    return _probe_geometry(pm, lo=8, hi=140)


def packed_spec(spec: ModelSpec, stage_b: str = "split") -> ModelSpec | None:
    """A ModelSpec running ``spec`` through the packed inference engine.

    Returns ``None`` when the model is not a supported ConvStack (U-Nets
    and exotic dilation schedules fall back to the plain path).  The
    returned spec shares the inner module's params tree; its
    ``size_multiple``/``size_offset`` encode the packing alignment so the
    tile planner keeps tiled == monolithic bitwise.  ``stage_b`` selects
    the dilated-stage formulation (see :class:`PackedConvStack`).
    """
    module = spec.module
    if not isinstance(module, ConvStack):
        return None
    try:
        pm = PackedConvStack(module, stage_b=stage_b)
        ctx, mult, off, min_size = _packed_geometry(module, stage_b)
    except (ValueError, TypeError):
        return None
    if ctx != spec.context:
        raise AssertionError(
            f"packed geometry context {ctx} != model context {spec.context}"
        )
    return ModelSpec(
        name=spec.name + "+packed",
        module=pm,
        context=ctx,
        size_multiple=mult,
        size_offset=off,
        min_size=min_size,
        metadata={**spec.metadata, "packed": True},
    )
