"""Training: on-device patch sampling, augmentation, and the jit train step.

Parity: flypylib fplnetwork.train + fplobjdetect.gen_batches (SURVEY.md
section 3.1): random patch sampling from labeled cubes restricted by a loss
mask, flip/rotation augmentation, masked binary cross-entropy, Adam.
flypylib trained from a *list* of labeled cubes; here multiple volumes are
padded to a common shape and stacked on a leading axis, with per-volume
corner bounds so sampling never strays into padding.

Design (SURVEY.md section 7.2 step 2, eval config 3 [B:9]): flypylib's
host-side Python batch generator was the known bottleneck; here the
labeled volumes live in device memory and the *entire* input pipeline — volume
pick + corner sampling (half uniform, half jittered around known
positives), patch gather (``lax.dynamic_slice`` under vmap), and the
16-element flip/rot augmentation — runs inside the single jit'd train
step.  The host supplies only a PRNG key per epoch; ``lax.scan`` batches a
whole epoch of steps into one dispatch, and uint8 grayscale stays uint8 on
device (normalized in-graph).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax

from flypylib_tpu.models.zoo import ModelSpec
from flypylib_tpu.ops.augment import AUGMENT_GROUP_SIZE, augment_patch


@dataclass(frozen=True)
class TrainConfig:
    patch_size: int = 33  # input patch edge (model-valid size enforced)
    batch_size: int = 32
    learning_rate: float = 1e-3
    pos_fraction: float = 0.5  # fraction of batch sampled near positives
    pos_jitter: int = 5  # voxel jitter around positive centers
    augment: bool = True
    steps_per_epoch: int = 100
    # "plain" runs the module; "packed" differentiates the
    # space-to-depth engine's forward_train (ConvStack without
    # BatchNorm, or the valid-conv U-Net) — same objective up to bf16
    # rounding (tests/test_packed_conv.py, tests/test_packed_unet.py).
    # "auto" (default) resolves to packed below the batch crossover
    # when the model supports it, else plain.
    engine: str = "auto"


# Packed-vs-plain batch crossover gating engine="auto".  It was measured
# on the platform the package was first built for (packed won at batch
# 64, plain at 128) and is unmeasured on the GPU; it stays the default
# until a train cell on the card replaces it.
_PACKED_BATCH_CROSSOVER = 96


def resolve_engine(spec: ModelSpec, cfg: TrainConfig) -> str:
    """The concrete engine ("plain" | "packed") a config runs.

    ``engine="auto"`` resolves to "packed" when the batch size is below
    the measured crossover AND the model has a differentiable packed
    forward (ConvStack without BatchNorm, or a valid-conv U-Net);
    otherwise "plain".  Explicit engines pass through (and keep their
    hard error on unsupported models, in resolve_train_spec)."""
    if cfg.engine != "auto":
        if cfg.engine not in ("plain", "packed"):
            raise ValueError(f"unknown engine {cfg.engine!r}")
        return cfg.engine
    if cfg.batch_size >= _PACKED_BATCH_CROSSOVER:
        return "plain"
    from flypylib_tpu.ops.packed_conv import PackedConvStack, packed_spec
    from flypylib_tpu.ops.packed_unet import PackedUNet, packed_unet_spec

    module = spec.module
    if isinstance(module, (PackedConvStack, PackedUNet)):
        if getattr(module, "stage_b", "split") == "group":
            return "plain"  # forward_train supports stage_b="split" only
        module = module.inner
        pspec = spec
    else:
        pspec = packed_spec(spec) or packed_unet_spec(spec)
    if pspec is None or getattr(module, "use_batchnorm", False):
        return "plain"  # no differentiable packed forward for this model
    return "packed"


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TrainState(_Replace):
    """Step counter, params, BatchNorm running stats and optimizer state
    (a pytree; ``tx`` is static metadata)."""

    step: jax.Array
    params: Any
    batch_stats: Any
    opt_state: Any
    tx: optax.GradientTransformation = dataclasses.field(
        metadata=dict(static=True)
    )

    @classmethod
    def create(cls, variables, tx):
        params = variables["params"]
        return cls(
            step=jnp.zeros((), jnp.int32),
            params=params,
            batch_stats=variables.get("batch_stats", {}),
            opt_state=tx.init(params),
            tx=tx,
        )


def masked_bce_loss(logits, labels, mask):
    """Loss-mask-weighted sigmoid binary cross-entropy (mean over mask)."""
    bce = optax.sigmoid_binary_cross_entropy(logits, labels)
    return jnp.sum(bce * mask) / jnp.maximum(jnp.sum(mask), 1.0)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TrainData(_Replace):
    """Stacked labeled volumes resident on device (a jit-able pytree).

    images/labels/masks: (V, Z, Y, X); corner_max: (V, 3) inclusive upper
    corner bound per volume; pos_locs: (N, 4) [v, z, y, x]; n_pos: scalar.
    """

    images: jax.Array
    labels: jax.Array
    masks: jax.Array
    corner_max: jax.Array
    pos_locs: jax.Array
    n_pos: jax.Array

    @classmethod
    def build(cls, images, labels, masks, patch: int, pos_cap: int = 65536):
        """Stack single or lists of (image, labels, mask) volumes; pads to
        a common shape (padding is mask-0 and never sampled)."""
        if not isinstance(images, (list, tuple)):
            images, labels, masks = [images], [labels], [masks]
        assert len(images) == len(labels) == len(masks)
        shapes = [np.asarray(im).shape for im in images]
        for s in shapes:
            if any(dim < patch for dim in s):
                raise ValueError(f"volume {s} smaller than patch {patch}")
        common = tuple(np.max(np.asarray(shapes), axis=0))

        def padded(v, fill=0.0):
            v = np.asarray(v, np.float32)
            pads = [(0, c - s) for s, c in zip(v.shape, common)]
            return np.pad(v, pads, constant_values=fill)

        img_dtype = np.asarray(images[0]).dtype
        if img_dtype == np.uint8:
            imgs = np.stack(
                [np.pad(np.asarray(im),
                        [(0, c - s) for s, c in zip(im.shape, common)])
                 for im in images]
            )
        else:
            imgs = np.stack([padded(im) for im in images])
        labs = np.stack([padded(lb) for lb in labels])
        msks = np.stack([padded(mk) for mk in masks])

        corner_max = np.asarray(
            [[dim - patch for dim in s] for s in shapes], np.int32
        )
        locs = []
        for v, lb in enumerate(labels):
            pts = np.argwhere(np.asarray(lb) > 0.5)
            if len(pts):
                locs.append(
                    np.concatenate(
                        [np.full((len(pts), 1), v), pts], axis=1
                    )
                )
        if locs:
            locs = np.concatenate(locs).astype(np.int32)
            if len(locs) > pos_cap:
                sel = np.random.default_rng(0).choice(
                    len(locs), pos_cap, replace=False
                )
                locs = locs[sel]
            n_pos = len(locs)
        else:
            locs = np.zeros((1, 4), np.int32)
            n_pos = 0
        return cls(
            images=jnp.asarray(imgs),
            labels=jnp.asarray(labs),
            masks=jnp.asarray(msks),
            corner_max=jnp.asarray(corner_max),
            pos_locs=jnp.asarray(locs),
            n_pos=jnp.int32(n_pos),
        )


def _sample_batch(key, n, data: TrainData, patch: int, cfg: TrainConfig):
    """(vidx (n,), corners (n,3)) mixing uniform and positive-centered."""
    k_v, k_u, k_p, k_j, k_mix = jax.random.split(key, 5)
    n_vols = data.images.shape[0]
    vidx_u = jax.random.randint(k_v, (n,), 0, n_vols)
    cmax_u = data.corner_max[vidx_u]  # (n, 3)
    u = jax.random.uniform(k_u, (n, 3))
    uniform = jnp.floor(u * (cmax_u + 1)).astype(jnp.int32)

    pidx = jax.random.randint(k_p, (n,), 0, jnp.maximum(data.n_pos, 1))
    pos = data.pos_locs[pidx]  # (n, 4) [v, z, y, x]
    jitter = jax.random.randint(
        k_j, (n, 3), -cfg.pos_jitter, cfg.pos_jitter + 1
    )
    centers = pos[:, 1:] + jitter
    pos_corner = jnp.clip(
        centers - patch // 2, 0, data.corner_max[pos[:, 0]]
    ).astype(jnp.int32)

    use_pos = (
        jax.random.uniform(k_mix, (n,)) < cfg.pos_fraction
    ) & (data.n_pos > 0)
    vidx = jnp.where(use_pos, pos[:, 0], vidx_u)
    corners = jnp.where(use_pos[:, None], pos_corner, uniform)
    return vidx, corners


def _gather(vols, vidx, corner, size):
    sl = jax.lax.dynamic_slice(
        vols, (vidx, corner[0], corner[1], corner[2]), (1, size, size, size)
    )
    return sl[0]


def resolve_train_spec(spec: ModelSpec, cfg: TrainConfig) -> ModelSpec:
    """The spec the train step actually differentiates.

    ``engine="packed"`` (or "auto" resolving to it) swaps in the packed
    spec (same params tree, stricter size constraints — its valid_size
    governs patch sampling, so Trainer.fit and make_loss_fn must both
    resolve through here).
    """
    if resolve_engine(spec, cfg) == "packed":
        from flypylib_tpu.ops.packed_conv import PackedConvStack, packed_spec
        from flypylib_tpu.ops.packed_unet import PackedUNet, packed_unet_spec

        if isinstance(spec.module, (PackedConvStack, PackedUNet)):
            return spec
        pspec = packed_spec(spec) or packed_unet_spec(spec)
        if pspec is None:
            raise ValueError(
                f"engine='packed' needs a ConvStack or UNetValid model "
                f"(got {spec.module!r})"
            )
        return pspec
    return spec


def make_loss_fn(spec: ModelSpec, cfg: TrainConfig, shard_batch=None):
    """Shared loss over TrainData; ``shard_batch`` optionally applies a
    sharding constraint to the sampled patch batch (mesh data parallelism).

    Returns ``(loss_fn, patch_size)``.
    """
    engine = resolve_engine(spec, cfg)
    spec = resolve_train_spec(spec, cfg)
    packed_fwd = (
        spec.module.forward_train if engine == "packed" else None
    )
    patch = spec.valid_size(cfg.patch_size)
    ctx = spec.context
    out = patch - 2 * ctx
    if out <= 0:
        raise ValueError(f"patch_size {patch} too small for context {ctx}")

    def loss_fn(params, batch_stats, key, data: TrainData):
        k_corner, k_aug = jax.random.split(key)
        vidx, corners = _sample_batch(
            k_corner, cfg.batch_size, data, patch, cfg
        )
        x = jax.vmap(
            lambda v, c: _gather(data.images, v, c, patch)
        )(vidx, corners)
        yc = corners + ctx
        y = jax.vmap(
            lambda v, c: _gather(data.labels, v, c, out)
        )(vidx, yc)
        m = jax.vmap(
            lambda v, c: _gather(data.masks, v, c, out)
        )(vidx, yc)
        x = x.astype(jnp.float32)
        if data.images.dtype == jnp.uint8:
            x = x * (1.0 / 255.0)

        if cfg.augment:
            codes = jax.random.randint(
                k_aug, (cfg.batch_size,), 0, AUGMENT_GROUP_SIZE
            )
            x = jax.vmap(augment_patch)(x, codes)
            y = jax.vmap(augment_patch)(y, codes)
            m = jax.vmap(augment_patch)(m, codes)

        if shard_batch is not None:
            x, y, m = shard_batch(x), shard_batch(y), shard_batch(m)

        variables = {"params": params}
        if batch_stats:
            variables["batch_stats"] = batch_stats
        if packed_fwd is not None:
            outputs = packed_fwd(variables, x[..., None])
        else:
            outputs = spec.module.apply(
                variables,
                x[..., None],
                train=True,
                mutable=["batch_stats"] if batch_stats else [],
            )
        logits, updates = outputs if isinstance(outputs, tuple) else (outputs, {})
        logits = logits[..., 0]
        loss = masked_bce_loss(logits, y, m)
        prob = jax.nn.sigmoid(logits)
        metrics = {
            "loss": loss,
            "pos_frac": jnp.mean(y),
            "pred_mean": jnp.mean(prob),
        }
        return loss, (metrics, updates.get("batch_stats", batch_stats))

    return loss_fn, patch


def make_step_impl(spec: ModelSpec, cfg: TrainConfig, shard_batch=None,
                   shard_grads=None):
    loss_fn, patch = make_loss_fn(spec, cfg, shard_batch)

    def step_impl(state, key, data: TrainData):
        grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
        (_, (metrics, new_bs)), grads = grad_fn(
            state.params, state.batch_stats, key, data
        )
        if shard_grads is not None:
            grads = shard_grads(grads)
        updates, opt_state = state.tx.update(grads, state.opt_state,
                                             state.params)
        params = optax.apply_updates(state.params, updates)
        return (
            state.replace(
                step=state.step + 1,
                params=params,
                batch_stats=new_bs,
                opt_state=opt_state,
            ),
            metrics,
        )

    return step_impl, patch


def make_train_step(spec: ModelSpec, cfg: TrainConfig, vol_shape=None):
    """(single_step, epoch_step, patch_size).

    ``epoch_step(state, keys, data)`` runs ``len(keys)`` steps in ONE
    dispatch via lax.scan — host dispatch latency is amortized over
    the whole epoch (the reference's per-batch host round-trip is the
    bottleneck this removes).  ``vol_shape`` is unused (kept for backward
    compatibility).
    """
    step_impl, patch = make_step_impl(spec, cfg)
    train_step = jax.jit(step_impl)

    @jax.jit
    def train_steps(state, keys, data):
        def body(state, key):
            return step_impl(state, key, data)

        state, metrics = jax.lax.scan(body, state, keys)
        return state, jax.tree.map(lambda m: jnp.mean(m), metrics)

    return train_step, train_steps, patch


class Trainer:
    """Host-side training driver: uploads volumes once, runs jit steps,
    tracks metrics, checkpoints via orbax."""

    def __init__(self, spec: ModelSpec, cfg: TrainConfig | None = None,
                 seed: int = 0, infer_spec: ModelSpec | None = None):
        """``infer_spec`` — the spec validation inference runs with
        (e.g. the packed engine); defaults to the training spec.
        FplNetwork passes its ``infer_spec`` down so validation epochs
        get the same engine + tiling policy as the infer verb."""
        self.spec = spec
        self.cfg = cfg or TrainConfig()
        self.infer_spec = infer_spec or spec
        self.key = jax.random.PRNGKey(seed)
        self.tx = optax.adam(self.cfg.learning_rate)
        self.state = None
        self._train_step = None
        self._val_engine = None  # cached TiledInference (re-jit is minutes)
        self._val_engine_key = None
        self.history: list[dict] = []

    def init_state(self, patch_size: int | None = None):
        self.key, k = jax.random.split(self.key)
        variables = self.spec.init(k, patch_size or self.cfg.patch_size)
        self.state = TrainState.create(variables, self.tx)
        return self.state

    def fit(
        self,
        image,
        labels,
        mask,
        epochs: int = 1,
        callback=None,
        val_data=None,
        val_tbars=None,
        val_every: int = 1,
        val_threshold: float = 0.5,
        val_window=3,
        val_dist_thresh: float = 10.0,
        metrics_log=None,
        mesh=None,
    ):
        """Train on one labeled volume or lists of them (parity:
        FplNetwork.train over labeled cube lists, incl. the validation
        data Keras ``fit`` carried).

        ``val_data``: optional ``(image, labels, mask)`` held-out volume —
        each ``val_every`` epochs the model runs full inference on it and
        the epoch record gains ``val_loss`` (masked BCE) and
        ``val_voxel_precision``/``val_voxel_recall`` (at
        ``val_threshold``).  ``val_tbars``: optional ground-truth point
        list — adds object-level ``val_obj_precision``/``val_obj_recall``
        (NMS at ``val_window``/``val_threshold``, greedy matching within
        ``val_dist_thresh``).  ``metrics_log``: optional
        :class:`flypylib_tpu.utils.metrics.MetricsLog` receiving every
        epoch record.

        ``mesh``: optional ``jax.sharding.Mesh`` with a ``"data"`` axis —
        the epoch step is then mesh-data-parallel (the global
        ``cfg.batch_size`` sharded over the axis, gradients all-reduced
        by XLA; flypylib ``multi_gpu.make_parallel`` parity, see
        flypylib_tpu.parallel.train).  Same seed => same params as the
        single-device path (the step body is shared; pinned by
        tests/test_parallel.py).
        """
        patch = resolve_train_spec(self.spec, self.cfg).valid_size(
            self.cfg.patch_size
        )
        data = TrainData.build(image, labels, mask, patch)

        if self.state is None:
            self.init_state()
        if self._train_step is None or mesh is not getattr(
            self, "_fit_mesh", None
        ):
            if mesh is not None:
                from flypylib_tpu.parallel.train import make_dp_train_step

                _, self._train_step, _ = make_dp_train_step(
                    self.spec, self.cfg, mesh
                )
            else:
                _, self._train_step, _ = make_train_step(self.spec, self.cfg)
            self._fit_mesh = mesh

        for epoch in range(epochs):
            self.key, k = jax.random.split(self.key)
            keys = jax.random.split(k, self.cfg.steps_per_epoch)
            self.state, metrics = self._train_step(self.state, keys, data)
            ep = {k2: float(v) for k2, v in metrics.items()}
            ep["epoch"] = epoch
            if val_data is not None and epoch % max(val_every, 1) == 0:
                ep.update(self._validate(
                    val_data, val_tbars, val_threshold, val_window,
                    val_dist_thresh,
                ))
            self.history.append(ep)
            if metrics_log is not None:
                metrics_log.log(ep)
            if callback:
                callback(ep)
        return self.history

    def _validate(self, val_data, val_tbars, threshold, window,
                  dist_thresh) -> dict:
        """Held-out metrics: masked-BCE loss, voxel PR, optional obj PR."""
        from flypylib_tpu.infer.tiled import TiledInference, default_tiling
        from flypylib_tpu.ops.matching import obj_pr, voxel_pr
        from flypylib_tpu.ops.nms import nms

        v_img, v_lab, v_mask = val_data
        variables = {"params": self.state.params}
        if self.state.batch_stats:
            variables["batch_stats"] = self.state.batch_stats
        # ONE inference engine reused across validation epochs — a fresh
        # TiledInference re-jits the tile forward every epoch; only the
        # variables change between epochs.  The engine is the REAL
        # inference path (infer_spec + default_tiling, like
        # FplNetwork.infer), not the plain module at constructor
        # defaults.
        v_img = np.asarray(v_img)
        tile_out, tile_batch = default_tiling(self.infer_spec, v_img.shape)
        key = (tile_out, tile_batch)
        if self._val_engine is None or self._val_engine_key != key:
            self._val_engine = TiledInference(
                self.infer_spec, variables, tile_out=tile_out,
                tile_batch=tile_batch,
            )
            self._val_engine_key = key
        self._val_engine.variables = variables
        prob = self._val_engine.infer(v_img)
        lab = np.asarray(v_lab, np.float32)
        msk = np.asarray(v_mask, np.float32)
        eps = 1e-7
        p = np.clip(prob, eps, 1 - eps)
        bce = -(lab * np.log(p) + (1 - lab) * np.log1p(-p))
        out: dict = {
            "val_loss": float(
                (bce * msk).sum() / max(msk.sum(), 1.0)
            )
        }
        vpr = voxel_pr(
            prob, lab, msk, thresholds=np.asarray([threshold], np.float32)
        )
        out["val_voxel_precision"] = float(vpr["precision"][0])
        out["val_voxel_recall"] = float(vpr["recall"][0])
        if val_tbars is not None:
            pred = nms(prob, window=window, threshold=threshold)
            pr, rc = obj_pr(pred, val_tbars, dist_thresh=dist_thresh)
            out["val_obj_precision"] = float(pr)
            out["val_obj_recall"] = float(rc)
        return out

    def save(self, path: str):
        import os

        import orbax.checkpoint as ocp

        path = os.path.abspath(path)  # orbax requires absolute paths
        ckpt = ocp.StandardCheckpointer()
        ckpt.save(
            path,
            {
                "params": jax.device_get(self.state.params),
                "batch_stats": jax.device_get(self.state.batch_stats),
            },
            force=True,
        )
        ckpt.wait_until_finished()

    def restore(self, path: str):
        import os

        import orbax.checkpoint as ocp

        path = os.path.abspath(path)
        if self.state is None:
            self.init_state()
        ckpt = ocp.StandardCheckpointer()
        target = {
            "params": jax.device_get(self.state.params),
            "batch_stats": jax.device_get(self.state.batch_stats),
        }
        restored = ckpt.restore(path, target)
        self.state = self.state.replace(
            params=restored["params"], batch_stats=restored["batch_stats"]
        )
        return self.state
