"""Space-to-depth packed inference engine for the valid-conv U-Net.

Same idea as :mod:`flypylib_tpu.ops.packed_conv` (every conv runs 8x the
channels on a half-resolution lattice), extended to the pooling topology:

- every valid 3^3 conv becomes a valid 2^3 conv on the 2x2x2-packed
  lattice (``pack_weight_d1`` embeds the original taps exactly);
- **max-pool 2^3 stride 2 is an elementwise max over the 8 parity
  channel groups** of the packed tensor (the pooling window IS one
  packed cell) — no spatial op at all;
- **ConvTranspose kernel-2 stride-2 is FOLDED into the next conv's
  weights**: output voxel ``2r+p`` receives exactly one tap,
  ``x[r] @ K[1-p]`` (``layers.conv_transpose`` reads the kernel
  flipped), and no activation sits between the upsample and the
  decoder block's first conv — so the conv's up-channel taps contract with ``K`` once, in the
  weights, shrinking the conv input from ``8(Cs+Cu)`` to ``8Cs + Cc``
  channels and removing the upsample op entirely;
- crop-and-concat skips are cropped IN the packed domain
  (:func:`crop_packed`: per-axis cell slices, parity swap on odd
  offsets) — full-resolution semantics with zero relayout transposes.

All rewrites re-associate the same multiply-adds, so outputs match
``UNetValid.apply`` to bf16 tolerance (tests/test_packed_unet.py).  The
packed model's size constraints are stricter (every pack step needs even
extents); :func:`packed_unet_spec` probes them numerically and exports a
drop-in ModelSpec, so TiledInference/DetectPipeline/sharded_infer work
unchanged.  Training delegates to the inner module (one params tree for
checkpoints and Keras import).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from flypylib_tpu.models.zoo import ModelSpec, UNetValid, _probe_geometry
from flypylib_tpu.ops.packed_conv import (
    pack_volume_iv,
    _PARITY,
    pack_volume,
    pack_weight_d1,
    unpack_volume,
    unpack_volume_iv,
)


def parity_group_max(x: jax.Array) -> jax.Array:
    """(B, D, H, W, 8C) packed -> (B, D, H, W, C): max over the parity
    groups == ``nn.max_pool(unpacked, (2,2,2), strides=(2,2,2))`` on the
    (even-extent) full-resolution tensor."""
    b, d, h, w, c8 = x.shape
    return x.reshape(b, d, h, w, 8, c8 // 8).max(axis=4)


def pool_pack(x: jax.Array, grad_exact: bool = False) -> jax.Array:
    """``pack_volume(parity_group_max(x))`` — the U-Net's per-level
    pool+repack.

    Values are bitwise identical across every form (max is exactly
    associative); the forms differ ONLY in speed and tie-gradient
    splitting:

    - max: a channel-slice ``jnp.maximum`` tree (no ``(..., 8, C)``
      minor-dim reshape).
      With ``grad_exact=True`` the :func:`parity_group_max` reduce is
      used instead, whose cotangent splits ties exactly like the plain
      engine's pool (the maximum chain orders ties differently; ReLU
      activations tie at 0.0 often, and the packed==plain TRAINING
      equality is test-pinned) — :meth:`PackedUNet.forward_train` sets
      it.
    - repack: :func:`pack_volume_iv` per-axis slices (no 8-D
      transpose, no triple-strided slices).
    """
    if any(s % 2 for s in x.shape[1:4]):
        raise ValueError(f"pool_pack needs even cell dims, got {x.shape}")
    if grad_exact:
        m = parity_group_max(x)
    else:
        c = x.shape[-1] // 8
        m = x[..., :c]
        for i in range(1, 8):
            m = jnp.maximum(m, x[..., i * c : (i + 1) * c])
    return pack_volume_iv(m)


def convT_packed_weight(k: jax.Array) -> jax.Array:
    """(2,2,2,Ci,Co) ConvTranspose kernel -> (Ci, 8Co) matrix whose
    output channels are parity-major packed.  The zoo's ConvTranspose
    (:func:`flypylib_tpu.models.layers.conv_transpose`) computes
    ``out[2r+p] = x[r] @ K[1-p]`` for kernel == stride == 2, so parity
    p reads the flipped tap."""
    cols = [k[1 - pz, 1 - py, 1 - px] for pz, py, px in _PARITY]
    return jnp.concatenate(cols, axis=-1)


def _concat_parity(a: jax.Array, b: jax.Array) -> jax.Array:
    """Per-parity-group channel concat of two packed tensors: matches
    ``concatenate([ua, ub], -1)`` on the unpacked voxels."""
    sa, sb = a.shape, b.shape
    ca, cb = sa[-1] // 8, sb[-1] // 8
    a = a.reshape(*sa[:-1], 8, ca)
    b = b.reshape(*sb[:-1], 8, cb)
    out = jnp.concatenate([a, b], axis=-1)
    return out.reshape(*sa[:-1], 8 * (ca + cb))


def _conv2(x, w):
    return lax.conv_general_dilated(
        x, w, (1, 1, 1), "VALID",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
    )


def crop_packed(x: jax.Array, starts, sizes) -> jax.Array:
    """Crop a packed tensor in FULL-RESOLUTION coordinates without
    leaving the packed domain: equivalent to
    ``pack_volume(unpack_volume(x)[starts : starts + sizes])`` but free
    of the two O(N) relayout transposes — per-axis cell *slices*, plus a
    parity-group swap when a start is odd.

    ``sizes`` must be even (packed lattices hold 2x2x2 cells).  Derivation
    per axis: output full-res index ``2r + p`` reads input ``2r + p + s``;
    for even ``s = 2k`` that is cell ``r + k`` parity ``p``; for odd
    ``s = 2k + 1`` parity 0 reads old parity 1 at cell ``r + k`` and
    parity 1 reads old parity 0 at cell ``r + k + 1``.
    """
    b, d, h, w, c8 = x.shape
    c = c8 // 8
    x = x.reshape(b, d, h, w, 2, 2, 2, c)
    for ax, (s, out_full) in enumerate(zip(starts, sizes)):
        if out_full % 2:
            raise ValueError(f"crop_packed sizes must be even, got {sizes}")
        n = out_full // 2
        sp_ax, p_ax = 1 + ax, 4 + ax
        k, r = divmod(int(s), 2)
        if r == 0:
            x = lax.slice_in_dim(x, k, k + n, axis=sp_ax)
        else:
            even = lax.slice_in_dim(
                lax.index_in_dim(x, 1, axis=p_ax, keepdims=False),
                k, k + n, axis=sp_ax,
            )
            odd = lax.slice_in_dim(
                lax.index_in_dim(x, 0, axis=p_ax, keepdims=False),
                k + 1, k + 1 + n, axis=sp_ax,
            )
            x = jnp.stack([even, odd], axis=p_ax)
    out_cells = tuple(sz // 2 for sz in sizes)
    return x.reshape(b, *out_cells, 8 * c)


class PackedUNet:
    """Duck-typed inference module running a UNetValid in packed layout.

    Drop-in for ``ModelSpec.module``: ``init`` delegates to the inner
    module (ONE params tree for both paths); ``apply`` runs the
    packed fast path for ``train=False`` and the inner module for
    training."""

    def __init__(self, inner: UNetValid, barriers: bool = False,
                 fold_form: str = "split"):
        # ``barriers``: materialize each pack_volume relayout with
        # lax.optimization_barrier before the conv that consumes it
        # (kept off by default; an A/B knob for the relayout placement)
        #
        # ``fold_form``: how each decoder stage consumes the PRE-concat
        # skip (sc) and upsampled (x) tensors:
        #   "split" (default): conv(sc, w_skip) + conv(x, w_up_eff)
        #             summed — the concat tensor never materializes;
        #             each input is read in its producer's layout.  Same
        #             products as "concat"; the accumulation grouping
        #             differs (bf16-class drift, within the engine's
        #             packed-vs-plain re-association contract;
        #             tiled==monolithic stays bitwise WITHIN the form).
        #   "concat": xin = concat([sc, x]); one fold conv.
        #   "split0": "split" at level 0 only.
        if fold_form not in ("concat", "split", "split0"):
            raise ValueError(f"unknown fold_form {fold_form!r}")
        self.inner = inner
        self.barriers = barriers
        self.fold_form = fold_form
        self.dtype = inner.dtype

    def init(self, key, x, train: bool = False):
        return self.inner.init(key, x, train=train)

    def apply(self, variables, x, train: bool = False, rngs=None, **kw):
        if train or kw.get("mutable"):
            return self.inner.apply(
                variables, x, train=train, rngs=rngs, **kw
            )
        return self._forward(variables, x)

    def forward_train(self, variables, x):
        """Differentiable packed forward (same exact re-association as
        :meth:`_forward`, f32 logits conv).

        Every engine op is differentiable — pack/unpack are
        transposes, ``pool_pack(grad_exact=True)`` is a reduce-max +
        slices (the plain engine pool's gradient; the inference-path
        maximum tree splits tie cotangents differently — see
        :func:`pool_pack`), ``crop_packed`` is slices, and the
        ConvTranspose/conv weight folds are contractions OF the params
        done inside the trace, so gradients flow to the original
        ConvTranspose and Conv kernels.  Only the split-weight bf16
        logits dot is swapped for the plain f32 conv: its mixed-dtype
        ``dot_general`` (bf16 operands, f32 accumulation) has no JAX
        transpose rule — same story as
        ``PackedConvStack.forward_train``.  UNetValid has no BatchNorm,
        so no running-stats caveat applies."""
        return self._forward(variables, x, f32_logits=True)

    def _forward(self, variables, x, f32_logits: bool = False):
        inner = self.inner
        params = variables["params"]
        dt = self.dtype
        cps = inner.convs_per_stage
        levels = inner.levels
        conv_i = 0

        def packed_conv_relu(x, i):
            w = params[f"Conv_{i}"]["kernel"].astype(dt)
            b = params[f"Conv_{i}"]["bias"].astype(dt)
            y = _conv2(x, pack_weight_d1(w)) + jnp.tile(b, 8)
            return jax.nn.relu(y)

        bar = lax.optimization_barrier if self.barriers else (lambda v: v)
        # de-interleave form (see pack_volume_iv)
        x = bar(pack_volume_iv(x.astype(dt)))
        skips = []
        for _ in range(levels):
            for _ in range(cps):
                x = packed_conv_relu(x, conv_i)
                conv_i += 1
            skips.append(x)
            # pool == parity-group max; re-pack via per-axis slices
            # (grad_exact on the differentiable path: the maximum-tree
            # form splits tie cotangents differently than the plain
            # engine's reduce — see pool_pack)
            x = bar(pool_pack(x, grad_exact=f32_logits))

        # bottleneck (packed one lattice deeper than the last skip)
        for _ in range(cps):
            x = packed_conv_relu(x, conv_i)
            conv_i += 1
        # interleave form (see unpack_volume_iv)
        x = bar(unpack_volume_iv(x))  # dense at the deepest resolution

        for lev in reversed(range(levels)):
            # x: DENSE tensor at this level's coarse resolution — which is
            # exactly the packed-fine lattice, so the ConvTranspose (a
            # linear per-parity 1x1 map, no activation before the next
            # conv) FOLDS into the level's first packed conv:
            #   up_group[p] = x @ K[1-p]  =>  the conv's up-channel taps
            #   contract with K once, in the weights.  This removes the
            #   upsample op AND shrinks the conv input from 8*(Cs+Cu)
            #   channels to 8*Cs + Cc — and the skip is cropped by pure
            #   packed-domain slices (crop_packed), so the decoder has
            #   no unpack->crop->repack relayouts.
            kT = params[f"ConvTranspose_{levels - 1 - lev}"]
            Kt = kT["kernel"].astype(jnp.float32)  # (2,2,2, Cc, Cu)
            bT = kT["bias"].astype(jnp.float32)  # (Cu,)
            cu = Kt.shape[-1]
            cc = Kt.shape[-2]
            skip = skips[lev]
            cs = skip.shape[-1] // 8

            w_conv = params[f"Conv_{conv_i}"]["kernel"].astype(jnp.float32)
            b_conv = params[f"Conv_{conv_i}"]["bias"].astype(jnp.float32)
            wp = pack_weight_d1(w_conv)  # (2,2,2, 8(Cs+Cu), 8Co)
            co8 = wp.shape[-1]
            wp = wp.reshape(2, 2, 2, 8, cs + cu, co8)
            w_skip = wp[..., :cs, :].reshape(2, 2, 2, 8 * cs, co8)
            w_up = wp[..., cs:, :]  # (2,2,2, parity a, Cu, 8Co)
            # K laid out parity-major (Cc, 8, Cu): group a holds K[1-a]
            k_par = convT_packed_weight(Kt).reshape(cc, 8, cu)
            w_up_eff = jnp.einsum("cau,zyxauo->zyxco", k_par, w_up)
            w_fold = jnp.concatenate([w_skip, w_up_eff], axis=3)
            # the convT bias reaches every up channel pre-conv: it sums
            # through all taps/parities into a per-output constant
            b_fold = jnp.tile(b_conv, 8) + jnp.einsum(
                "u,zyxauo->o", bT, w_up
            )

            # crop the skip to full-res extent 2*x.shape (pure slices)
            sizes = [2 * x.shape[i] for i in (1, 2, 3)]
            starts = [
                skip.shape[i] - x.shape[i] for i in (1, 2, 3)
            ]  # (2*cells - size)//2 per side
            sc = crop_packed(skip, starts, sizes)

            use_split = self.fold_form == "split" or (
                self.fold_form == "split0" and lev == 0
            )
            if use_split:
                # pre-concat consumption: two convs summed; the
                # (8Cs+Cc)-channel boundary tensor never materializes
                y = (
                    _conv2(sc, w_skip.astype(dt))
                    + _conv2(x.astype(dt), w_up_eff.astype(dt))
                    + b_fold.astype(dt)
                )
                x = jax.nn.relu(y)
                conv_i += 1
                for _ in range(cps - 1):
                    x = packed_conv_relu(x, conv_i)
                    conv_i += 1
                if lev > 0:
                    x = bar(unpack_volume_iv(x))
                continue
            xin = jnp.concatenate([sc, x.astype(dt)], axis=-1)
            y = _conv2(xin, w_fold.astype(dt)) + b_fold.astype(dt)
            x = jax.nn.relu(y)
            conv_i += 1
            for _ in range(cps - 1):
                x = packed_conv_relu(x, conv_i)
                conv_i += 1
            if lev > 0:
                # dense input for the next fold (interleave form — see
                # the bottleneck unpack)
                x = bar(unpack_volume_iv(x))

        # logits 1x1 conv (parity-independent): split-weight bf16 with
        # f32 accumulation (same trick as PackedConvStack — bf16->f32 is
        # value-exact on activations, only the weight needs two terms);
        # the differentiable path (f32_logits) runs the plain f32 dot
        # instead — the mixed-dtype form has no JAX transpose rule
        wl = params[f"Conv_{conv_i}"]["kernel"].astype(jnp.float32)
        bl = params[f"Conv_{conv_i}"]["bias"].astype(jnp.float32)
        w0 = wl[0, 0, 0]  # (C, 1)
        b_, d, h, w_sp, c8 = x.shape
        if f32_logits:
            xg = x.reshape(b_, d, h, w_sp, 8, c8 // 8).astype(jnp.float32)
            y = jax.lax.dot_general(
                xg, w0, (((5,), (0,)), ((), ()))
            )[..., 0] + bl  # (B, D, H, W, 8)
        else:
            # block-diagonal (8C, 8) weight: y[..., p] = x-group-p @ w0.
            # Same products as the grouped (..., 8, C) dot but WITHOUT
            # the minor-dim reshape.  Not bitwise vs the grouped form:
            # the 8C-wide dot's partial sums chunk differently (pure
            # f32 accumulation order).
            eye = jnp.eye(8, dtype=jnp.float32)
            w_bd = jnp.einsum("c,gp->gcp", w0[:, 0], eye).reshape(c8, 8)
            w_hi = w_bd.astype(dt)
            w_lo = (w_bd - w_hi.astype(jnp.float32)).astype(dt)
            wcat = jnp.concatenate([w_hi, w_lo], axis=-1)  # (8C, 16)
            y = jax.lax.dot_general(
                x, wcat,
                (((4,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )  # (B, D, H, W, 16)
            y = y[..., :8] + y[..., 8:] + bl  # (B, D, H, W, 8)
        return unpack_volume_iv(y.reshape(b_, d, h, w_sp, 8 * 1))

    def __repr__(self):
        return f"PackedUNet({self.inner!r})"


@functools.lru_cache(maxsize=8)
def _packed_unet_geometry(module: UNetValid):
    pm = PackedUNet(module)
    return _probe_geometry(pm, lo=8, hi=200)


def packed_unet_spec(spec: ModelSpec,
                     barriers: bool = False,
                     fold_form: str = "split") -> ModelSpec | None:
    """A ModelSpec running a UNetValid ``spec`` through the packed
    engine, or ``None`` when the module is not a UNetValid.  Shares the
    inner params tree; exports the packed (stricter) size constraints.

    ``fold_form`` selects how decoder stages consume the pre-concat
    skip/upsampled tensors ("split" — the measured default — "split0",
    or "concat"; see :class:`PackedUNet`)."""
    module = spec.module
    if not isinstance(module, UNetValid):
        return None
    try:
        pm = PackedUNet(module, barriers=barriers, fold_form=fold_form)
        ctx, mult, off, min_size = _packed_unet_geometry(module)
    except (ValueError, TypeError):
        return None
    return ModelSpec(
        name=spec.name + "+packed",
        module=pm,
        context=ctx,
        size_multiple=mult,
        size_offset=off,
        min_size=min_size,
        metadata={**spec.metadata, "packed": True},
    )
