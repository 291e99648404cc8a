"""FplNetwork — the flypylib-compatible public API surface.

Parity: flypylib fplnetwork.FplNetwork (SURVEY.md section 2.2 row 1): owns
a model from the zoo, trains on labeled volumes, runs fully-convolutional
sliding-window inference on large volumes, and exposes the
train / infer / nms / evaluate verbs end to end.

Construction accepts either a zoo name (``FplNetwork("baseline")``), a zoo
callable, or a ready ``ModelSpec`` — mirroring flypylib's
``FplNetwork(model_fn)`` convention while staying functional underneath
(params are an explicit pytree, never hidden mutable state).
"""

from __future__ import annotations

import logging

import numpy as np

from flypylib_tpu.infer.tiled import TiledInference
from flypylib_tpu.io.synapses import Tbars, make_training_volumes
from flypylib_tpu.models.zoo import MODEL_ZOO, ModelSpec
from flypylib_tpu.ops.components import label_components
from flypylib_tpu.ops.nms import nms
from flypylib_tpu.train.trainer import TrainConfig, Trainer

logger = logging.getLogger("flypylib_tpu")


def _staged_fits_hbm(vol: np.ndarray, n_devices: int = 1,
                     headroom: float = 0.6,
                     bytes_limit: int | None = None) -> bool:
    """True when the device-resident (staged) detection mode fits EACH
    participating device: the volume at its wire dtype (uint8 stays
    uint8 on device — infer/large.py stages raw chunks; replicated per
    device under ``devices=`` fan-out) plus this device's share of the
    f32 probability shell (z-bands split it ~evenly across devices),
    against ``headroom`` of the device budget (``bytes_limit``, default
    :func:`~flypylib_tpu.utils.memory.device_bytes_limit`).  Forward
    activations and postprocess buffers ride in the remainder (the
    shared forward's per-dispatch footprint is tile-bounded)."""
    from flypylib_tpu.utils.memory import device_bytes_limit

    if bytes_limit is None:
        bytes_limit = device_bytes_limit()
    shell = 4 * vol.size / max(1, int(n_devices))
    return vol.nbytes + shell <= headroom * bytes_limit


class FplNetwork:
    def __init__(self, model="baseline", train_config: TrainConfig | None = None,
                 seed: int = 0, packed: bool | str = "auto", **model_kwargs):
        """``packed`` selects the space-to-depth inference engine
        (ops/packed_conv for ConvStack zoo entries, ops/packed_unet for
        the valid-conv U-Net) for the infer/detect verbs: ``"auto"``
        uses it whenever the model supports it, ``True`` requires it,
        ``False`` runs the plain module.  Training picks its own engine
        (``TrainConfig.engine``); all paths share one params tree."""
        if isinstance(model, ModelSpec):
            spec = model
        elif callable(model):
            spec = model(**model_kwargs)
        else:
            spec = MODEL_ZOO[model](**model_kwargs)
        self.spec = spec
        self.context = spec.context
        self.infer_spec = spec
        if packed:
            from flypylib_tpu.ops.packed_conv import packed_spec
            from flypylib_tpu.ops.packed_unet import packed_unet_spec

            pspec = packed_spec(spec) or packed_unet_spec(spec)
            if pspec is None and packed is True:
                raise ValueError(
                    f"model {spec.name!r} does not support the packed "
                    "inference engine"
                )
            self.infer_spec = pspec or spec
        self.trainer = Trainer(spec, train_config, seed=seed,
                               infer_spec=self.infer_spec)
        self._tiled: TiledInference | None = None
        self._tiled_key = None

    # -- train ------------------------------------------------------------
    def train(
        self,
        image,
        labels=None,
        mask=None,
        tbars=None,
        epochs: int = 1,
        radius: float = 5.0,
        callback=None,
        **fit_kwargs,
    ):
        """Train on one labeled cutout or a LIST of them (parity: flypylib
        trained over lists of labeled cubes).

        Either pass rasterized ``labels``+``mask`` volumes, or raw ``tbars``
        annotations (rasterized here with the standard radius/ignore-annulus
        rules; border masking uses the model context).

        Pass ``mesh=jax.sharding.Mesh(..., ("data",))`` (forwarded to
        :meth:`Trainer.fit`) for mesh-data-parallel training — the
        equivalent of flypylib's ``make_parallel`` multi-GPU path, wired
        into the same public verb.
        """
        is_multi = isinstance(image, (list, tuple))
        images = list(image) if is_multi else [image]
        if labels is None:
            if tbars is None:
                raise ValueError("need labels+mask or tbars")
            tbars_list = list(tbars) if is_multi else [tbars]
            pairs = [
                make_training_volumes(
                    tb, im.shape, radius=radius, border=self.context
                )
                for tb, im in zip(tbars_list, images)
            ]
            labels = [p[0] for p in pairs]
            mask = [p[1] for p in pairs]
        else:
            labels = list(labels) if is_multi else [labels]
            if mask is None:
                mask = [np.ones_like(lb, dtype=np.float32) for lb in labels]
            else:
                mask = list(mask) if is_multi else [mask]
        history = self.trainer.fit(images, labels, mask, epochs=epochs,
                                   callback=callback, **fit_kwargs)
        self._tiled = None  # params changed; rebuild inference wrapper lazily
        return history

    @property
    def variables(self):
        state = self.trainer.state
        if state is None:
            self.trainer.init_state()
            state = self.trainer.state
        v = {"params": state.params}
        if state.batch_stats:
            v["batch_stats"] = state.batch_stats
        return v

    # -- infer ------------------------------------------------------------
    def infer(
        self,
        volume: np.ndarray,
        tile_out: int | None = None,
        tile_batch: int | None = None,
        keep_on_device: bool = False,
    ):
        """Whole-volume probability map via overlap-tiled inference.

        ``tile_out``/``tile_batch`` default to the model-aware choice
        (:func:`flypylib_tpu.infer.tiled.default_tiling`): one covering
        tile for pooling topologies, batched 64-wide tiles for conv
        stacks.  Results are identical either way — tiled == monolithic
        is test-pinned."""
        if tile_out is None or tile_batch is None:
            from flypylib_tpu.infer.tiled import default_tiling

            d_out, d_batch = default_tiling(
                self.infer_spec, np.asarray(volume).shape
            )
            tile_out = d_out if tile_out is None else tile_out
            tile_batch = d_batch if tile_batch is None else tile_batch
        key = (tile_out, tile_batch)
        if self._tiled is None or self._tiled_key != key:
            self._tiled = TiledInference(
                self.infer_spec, self.variables, tile_out=tile_out,
                tile_batch=tile_batch,
            )
            self._tiled_key = key
        else:
            self._tiled.variables = self.variables
        return self._tiled.infer(volume, keep_on_device=keep_on_device)

    # -- nms / detect ------------------------------------------------------
    @staticmethod
    def nms(prob, window=3, threshold: float = 0.5) -> Tbars:
        return nms(prob, window=window, threshold=threshold)

    @staticmethod
    def components(prob, threshold: float = 0.5) -> Tbars:
        return label_components(prob, threshold=threshold)

    def detect(
        self,
        volume: np.ndarray,
        window=5,
        threshold: float = 0.5,
        tile_out: int | None = None,
        tile_batch: int | None = None,
        method: str = "nms",
    ) -> Tbars:
        """infer + nms/cc in one pass with the prob map kept on device.

        ``window`` defaults to 5 — the ONE detection-verb default,
        shared with :meth:`detect_large` (same verb, same list
        regardless of volume size; the bare :meth:`nms` verb keeps
        ``ops.nms``'s window=3).  ``tile_out``/``tile_batch`` default
        model-aware — see :meth:`infer`."""
        prob = self.infer(
            volume, tile_out=tile_out, tile_batch=tile_batch,
            keep_on_device=True,
        )
        if method == "nms":
            return nms(prob, window=window, threshold=threshold)
        elif method == "components":
            return label_components(prob, threshold=threshold)
        raise ValueError(f"unknown method {method!r}")

    def detect_large(
        self,
        volume,
        window=5,
        threshold: float = 0.5,
        core: int | None = None,
        method: str = "nms",
        staged: bool | None = None,
        **kw,
    ):
        """Detection over volumes of any size with exact whole-volume
        semantics (infer/large.py).  ``volume`` is an ndarray, an HDF5
        path, or a ``(shape, read_fn)`` pair.  ``window=5`` is the
        shared detection-verb default (== :meth:`detect`).
        ``staged=True`` keeps the whole volume device-resident and
        slices ROIs on device (default for in-RAM volumes that fit the
        device per :func:`_staged_fits_hbm`), else ROIs stream from host
        memory / disk with bounded device memory.  Both modes default
        to ``forward="auto"``: ONE shared forward per volume (staged) or
        per z-band of ROI rows (streaming) when it fits the device
        budget — no per-ROI forward redundancy — else per-ROI forwards;
        pass ``forward="roi"``/``"shared"`` to pin.  The chosen modes
        are logged on the ``flypylib_tpu`` logger at INFO.
        On a multi-device host pass ``devices=jax.local_devices()``
        (staged mode) to fan the sweep over every device — roi mode
        round-robins ROIs, shared mode forwards one z-band per device."""
        from flypylib_tpu.infer.large import (
            detect_h5,
            detect_staged,
            detect_streaming,
        )

        common = dict(
            window=window, threshold=threshold, core=core, method=method,
            **kw,
        )
        if isinstance(volume, str):
            return detect_h5(self.infer_spec, self.variables, volume,
                             **common)
        if isinstance(volume, tuple) and callable(volume[1]):
            shape, read = volume
            return detect_streaming(self.infer_spec, self.variables, shape,
                                    read, **common)
        vol = np.asarray(volume)
        if staged is None:
            # device-resident when it fits each participating device
            devs = kw.get("devices")
            staged = _staged_fits_hbm(vol, n_devices=len(devs or ()) or 1)
        logger.info("detect_large: %s (volume %s %s)",
                    "staged" if staged else "streaming", vol.shape,
                    vol.dtype)
        if staged:
            return detect_staged(self.infer_spec, self.variables, vol,
                                 **common)
        from flypylib_tpu.infer.large import array_reader

        shape, read = array_reader(vol)
        return detect_streaming(self.infer_spec, self.variables, shape,
                                read, **common)

    # -- evaluate ----------------------------------------------------------
    @staticmethod
    def evaluate(pred_or_prob, gt: Tbars, dist_thresh: float = 10.0,
                 window=3, threshold: float = 0.5):
        from flypylib_tpu.ops.matching import evaluate as _evaluate

        return _evaluate(pred_or_prob, gt, dist_thresh=dist_thresh,
                         window=window, threshold=threshold)

    def evaluate_voxels(
        self,
        image,
        labels,
        mask=None,
        thresholds=None,
        slab: int | None = None,
        bytes_limit: int | None = None,
    ):
        """Voxel-wise PR of this model's prediction against a label
        volume (eval config 4's on-device PR evaluation, BASELINE.json:10).

        Volumes whose prob, labels, mask and input (16 bytes a voxel)
        fit a quarter of the device budget (``bytes_limit``, default
        :func:`~flypylib_tpu.utils.memory.device_bytes_limit`) run one
        on-device forward + count
        (:func:`~flypylib_tpu.ops.matching.voxel_pr_device` — the
        probability map never leaves the device); larger ones (or any input
        given as a ``(shape, read_fn)`` reader, e.g.
        :func:`~flypylib_tpu.infer.large.h5_reader`) stream
        pooling-phase-aligned z-slabs in bounded memory with identical
        results (:func:`~flypylib_tpu.ops.matching.voxel_pr_streaming`)."""
        from flypylib_tpu.ops.matching import (
            voxel_pr_device,
            voxel_pr_streaming,
        )

        is_reader = isinstance(image, tuple) and callable(image[1])
        small = not is_reader and slab is None
        if small:
            from flypylib_tpu.utils.memory import device_bytes_limit

            if bytes_limit is None:
                bytes_limit = device_bytes_limit()
            small = 16 * np.asarray(image).size <= bytes_limit // 4
        if small:
            prob = self.infer(image, keep_on_device=True)
            return voxel_pr_device(prob, np.asarray(labels, np.float32),
                                   mask, thresholds=thresholds)
        return voxel_pr_streaming(
            self.infer_spec, self.variables, image, labels, mask=mask,
            thresholds=thresholds, **({} if slab is None else {"slab": slab}),
        )

    # -- checkpointing -----------------------------------------------------
    def save(self, path: str):
        self.trainer.save(path)

    def restore(self, path: str):
        self.trainer.restore(path)
        self._tiled = None
