"""Out-of-core / HBM-resident whole-volume detection.

Detection over volumes of any size runs ROI-by-ROI with *exact*
whole-volume semantics.  Two transports share one plan/postprocess engine
(:class:`_StreamPlan`):

- :func:`detect_streaming` — out-of-core: ROI blocks are read on the host
  (HDF5 / DVID / any ``read_fn``) with a prefetch thread, bounded host and
  device memory;
- :func:`detect_staged` — HBM-resident: the whole volume is staged on
  device once (uint8 on the wire) and ROI blocks are sliced
  device-to-device, so the steady state never touches the host wire (the
  chip-bound 1k^3 north-star mode [B:5][B:8]).

Both are pipelined with lag 1: ROI *i*+1's forward is dispatched before
ROI *i*'s postprocess transfer blocks the host.  Semantics:

- **NMS**: each core ROI is fetched with a halo of ``context + window//2``
  true neighbor voxels (so every probability value a core voxel's NMS
  window touches is computed from real data, never from ROI padding),
  out-of-volume parts are reflect-filled in ONE pad (matching a monolithic
  run's face padding), and candidates are kept only by core ownership — a
  detection at a seam is reported exactly once, with exactly the
  monolithic decision.  Pinned by tests/test_large.py: chunked == full
  volume, bit-for-bit.
- **Connected components** (``method="components"``), two exact
  backends selected by ``cc_impl``:

  * ``"sparse"`` (default): each core ROI compacts ALL its
    above-threshold core voxels on device and ships only the tiny
    (index, prob) candidate list; one host ``scipy.sparse.csgraph`` pass
    over the global union then labels components with exact
    6-connectivity (ops.components.components_from_candidates).  Work
    scales with candidate count — the right trade for the ~0.01-1%
    occupied masks synapse detection produces.
  * ``"device"``: each core ROI labels its (disjoint) core box on device
    (label-propagation sweeps) and exports compacted component stats
    plus sparse boundary-face labels; a host union-find merges
    components that are 6-adjacent across ROI seams (same trick as
    flypylib_tpu.parallel.halo.sharded_components, extended to a 3-D
    ROI grid).  Better when masks are dense (e.g. membrane maps).

  Both produce centroids/confidences equal to a monolithic
  ``scipy.ndimage.label`` run exactly — pinned by tests/test_large.py on
  non-divisible cores.
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from flypylib_tpu.infer.pipeline import DetectPipeline
from flypylib_tpu.io.synapses import Tbars
from flypylib_tpu.models.zoo import ModelSpec
from flypylib_tpu.ops.host_reference import sort_detections
from flypylib_tpu.utils import to3d

logger = logging.getLogger("flypylib_tpu")

# Device-memory model shared by the shared-forward gates: conv stacks
# chunk stage-A activations to ~1.5 GB per dispatch, and every estimate
# keeps half a GiB for executables and small buffers.
_CONV_STACK_ACT_BYTES = 2 << 30
_SLACK_BYTES = 1 << 29


def h5_reader(path: str, dataset: str | None = None):
    """(shape, read_fn) for an HDF5 dataset; read_fn(lo, hi) -> array."""
    import h5py

    f = h5py.File(path, "r")
    if dataset is None:
        from flypylib_tpu.io.hdf5 import DEFAULT_DATASET

        dataset = DEFAULT_DATASET if DEFAULT_DATASET in f else next(iter(f))
    ds = f[dataset]

    def read(lo, hi):
        return ds[tuple(slice(a, b) for a, b in zip(lo, hi))]

    return tuple(ds.shape), read


def array_reader(vol: np.ndarray):
    """In-RAM adapter with the same (shape, read_fn) interface."""
    vol = np.asarray(vol)

    def read(lo, hi):
        return vol[tuple(slice(a, b) for a, b in zip(lo, hi))]

    return vol.shape, read


def dvid_reader(client, instance: str, shape, offset=(0, 0, 0)):
    """(shape, read_fn) streaming grayscale straight from a DVID node.

    Feeds :func:`detect_streaming` / ``FplNetwork.detect_large`` without
    ever holding the whole volume in host RAM — each ROI/halo window is
    one ``/raw`` cutout GET (uint8 on the wire, the client retries
    transient failures).  ``shape``/``offset`` are (z, y, x): the box of
    the DVID volume to treat as the detection domain.  Parity: flypylib
    fetched DVID cutouts per block for its large-volume path (SURVEY.md
    section 2.2 row 4 / eval config 5)."""
    shape = to3d(shape)
    offset = to3d(offset)

    def read(lo, hi):
        size = tuple(int(b - a) for a, b in zip(lo, hi))
        off = tuple(int(o + a) for o, a in zip(offset, lo))
        return client.get_gray3d(instance, size=size, offset=off)

    return tuple(int(s) for s in shape), read


def _default_tile(
    extent: int, spec: ModelSpec, target: int = 64, cap: int = 176
) -> int:
    """Default streaming tile: the valid divisor of the ROI extent
    nearest ``target`` (within [target//2, cap]), phase-aligned.

    A divisor means the static tile grid covers the ROI exactly (no
    overshoot -> no redundant conv FLOPs).  Small-ish tiles win twice:
    per-tile activation memory stays bounded (XLA may materialize conv
    input patches for one monolithic big-spatial ROI tile), and batched small-spatial convs ran faster than big tiles
    despite the halo redundancy on the platform the defaults were
    first tuned on (not yet re-measured on the GPU).

    Total under the memory cap: when no divisor exists (prime-ish
    extents), fall back to the largest valid tile <= cap and accept an
    overshooting tile grid (the tile planner pads and crops overshoot;
    detections are unaffected) — never the monolithic ``extent``, which
    OOMs past ~200^3."""
    if extent <= cap:
        if extent <= 2 * target:
            return extent
    mult = max(spec.size_multiple, 1)
    best = None
    for d in range(max(target // 2, mult), min(cap, extent) + 1):
        if extent % d == 0 and d % mult == 0 and spec.is_valid_size(
            d + 2 * spec.context
        ):
            if best is None or abs(d - target) < abs(best - target):
                best = d
    if best is not None:
        return best
    # no exact divisor: overshooting grid with the largest valid tile
    # under the cap (fewest tiles -> least halo redundancy)
    for d in range(min(cap, extent), mult - 1, -1):
        if d % mult == 0 and spec.is_valid_size(d + 2 * spec.context):
            return d
    return extent  # degenerate (extent < size_multiple): nothing to split


@functools.partial(jax.jit, static_argnames=("size",))
def _slice_window(big, start, size):
    """Device slice of one (tin, py, px) slab window from a monolithic
    staged volume (shared-forward mode)."""
    return lax.dynamic_slice(big, (start[0], start[1], start[2]), size)


class _StreamPlan:
    """Shared geometry + per-ROI postprocess/merge engine for the
    streaming paths (host-read :func:`detect_streaming` and HBM-resident
    :func:`detect_staged` — identical semantics, different block
    transport)."""

    def __init__(
        self,
        spec: ModelSpec,
        variables,
        shape,
        core: int,
        tile_out: int | None,
        tile_batch: int | None,
        window,
        threshold: float,
        max_detections_per_roi: int,
        max_components_per_roi: int,
        method: str,
        cc_impl: str = "sparse",
        fused_impl: str = "filter",
    ):
        if method not in ("nms", "components", "both"):
            raise ValueError(f"unknown method {method!r}")
        if cc_impl not in ("sparse", "device"):
            raise ValueError(f"unknown cc_impl {cc_impl!r}")
        if fused_impl not in ("nbr", "filter"):
            raise ValueError(f"unknown fused_impl {fused_impl!r}")
        self.fused_impl = fused_impl
        self.want_nms = method in ("nms", "both")
        self.want_cc = method in ("components", "both")
        self.method = method
        self.cc_impl = cc_impl
        self.threshold = threshold

        self.shape = shape = to3d(shape)
        self.window = win = to3d(window)
        ctx = spec.context
        h = ctx + (max(win) // 2 if self.want_nms else 0)
        h = max(h, ctx)  # CC needs at least the conv context halo
        from flypylib_tpu.infer.tiled import tiling_regime
        from flypylib_tpu.utils import round_up

        mult = spec.size_multiple
        pooled = tiling_regime(spec) == "cover" and mult > 1
        if pooled:
            # Pooling models are shift-equivariant only modulo the
            # pooling stride: an ROI forward anchored at
            # corner - fetch_halo matches the monolithic run (anchored
            # at -context) iff corner - h = 0 (mod size_multiple).
            # Round the halo up and snap core dims below so EVERY ROI
            # keeps the monolithic pooling phase — without this,
            # streamed U-Net detections silently diverge (caught by
            # tests/test_large.py::test_pooled_default_core_and_tile).
            # The extra halo voxels are true data (or the same single
            # reflect continuation) and are masked/cropped exactly.
            h = round_up(h, mult)
        self.ctx, self.h = ctx, h
        # plus the conv context for the halo's own probs
        self.fetch_halo = h + ctx

        # core may be an int (cubic) or a (z, y, x) triple — anisotropic
        # cores cut the ROI count (fixed per-ROI postprocess cost) while
        # keeping per-axis halo redundancy low
        self.core = int(core) if np.isscalar(core) else tuple(to3d(core))
        core3 = [
            round_up(c, mult) if pooled else c for c in to3d(core)
        ]
        self.core_dims = [min(c, s) for c, s in zip(core3, shape)]
        # ownership partition: non-overlapping cores covering the volume
        starts = [
            list(range(0, s, c)) for s, c in zip(shape, self.core_dims)
        ]
        self.grid = [
            ((iz, iy, ix), (z0, y0, x0))
            for iz, z0 in enumerate(starts[0])
            for iy, y0 in enumerate(starts[1])
            for ix, x0 in enumerate(starts[2])
        ]

        self.req_tile = (tile_out, tile_batch)  # as passed (for _check_plan)
        roi_extent = max(self.core_dims) + 2 * h
        from flypylib_tpu.infer.tiled import default_tiling, tiling_regime

        if tiling_regime(spec) == "cover":
            # pooling topologies: one covering tile per ROI when it
            # fits, else the largest tile under the cap — the U-Net
            # chain rate grows with tile size and grids pay 2-3x halo
            # redundancy
            d_out, d_batch = default_tiling(spec, (roi_extent,) * 3)
            if tile_out is None:
                tile_out = d_out
            if tile_batch is None:
                tile_batch = d_batch
        if tile_out is None:
            tile_out = _default_tile(roi_extent, spec)
        if tile_batch is None:
            # several small tiles per z-slab dispatch (the default
            # from the first platform; not yet swept on the GPU)
            tile_batch = min(16, max(1, (roi_extent // tile_out) ** 2))
        self.pipe = DetectPipeline(
            spec, variables,
            vol_shape=tuple(c + 2 * h for c in self.core_dims),
            tile_out=min(tile_out, roi_extent),
            tile_batch=tile_batch,
            window=window, threshold=threshold,
            max_detections=max_detections_per_roi,
            run_cc=False, pre_padded=True,
        )
        self.K = max_components_per_roi
        self._nms_K = max_detections_per_roi  # shared-mode NMS slots
        self.F = 8192  # sparse-face slots per ROI face (grows on retry)
        # sparse-CC candidate slots per ROI (grows on retry); sized so
        # the steady-state wire cost stays ~0.5 MB/ROI
        self.C = 65536
        # depth of the dispatch-ahead pipeline: each in-flight ROI holds
        # one prob-map buffer in HBM, so scale the window down for big
        # ROIs (budget ~2.5 GB of held maps); overridable attribute
        out_bytes = 4 * int(np.prod(self.pipe._out_shape))
        self.pipeline_window = max(
            1, min(4, (5 << 29) // max(out_bytes, 1))
        )

    def region(self, corner):
        """(lo_want, vlo, vhi) for an ROI corner: the wanted fetch box and
        the prob-region coords of the true-volume box (voxels outside are
        masked to -inf — monolithic boundary semantics)."""
        lo_want = [c - self.fetch_halo for c in corner]
        region0 = [v + self.ctx for v in lo_want]
        vlo = [max(0, -r0) for r0 in region0]
        vhi = [
            min(cd + 2 * self.h, s - r0)
            for cd, s, r0 in zip(self.core_dims, self.shape, region0)
        ]
        return lo_want, vlo, vhi

    def _cc_core_export(self, corep, thr, K: int, F: int):
        """Traced device-CC body shared by the per-ROI and shared-forward
        extractors: label the (cz, cy, cx) core box, export compacted
        component stats plus sparse boundary-face labels."""
        from flypylib_tpu.ops.components import (
            cc_label_and_extract,
            compact_true_indices,
        )

        cz, cy, cx = self.core_dims
        sentinel = cz * cy * cx
        uniq, sums, count, conf, valid, over_k, lab = (
            cc_label_and_extract(corep, thr, K)
        )
        # sparse face export: a 512^2 label plane is megabytes of
        # device->host traffic per ROI, but only labeled (above-threshold)
        # face voxels can seam-merge — ship (position, label) pairs
        # compacted to F slots per face; face overflow gets its OWN
        # retry flag so a K-only overflow doesn't inflate F
        over_f = jnp.bool_(False)
        faces = []
        for plane in (
            lab[0], lab[cz - 1],
            lab[:, 0], lab[:, cy - 1],
            lab[:, :, 0], lab[:, :, cx - 1],
        ):
            flat = plane.reshape(-1)
            m = flat < sentinel
            fcap = min(F, flat.shape[0])
            idx = compact_true_indices(m, fcap)
            v = idx < flat.shape[0]
            labs = jnp.where(
                v,
                flat[jnp.minimum(idx, flat.shape[0] - 1)],
                sentinel,
            )
            if fcap < flat.shape[0]:
                over_f = over_f | (
                    jnp.sum(m, dtype=jnp.int32) > fcap
                )
            faces.append((idx, labs))
        return uniq, sums, count, conf, valid, over_k, over_f, faces

    def _cc_fn(self, K: int, F: int):
        try:
            return self._cc_cache[(K, F)]
        except (AttributeError, KeyError):
            pass
        vz, vy, vx = self.pipe.vol_shape
        h = self.h
        cz, cy, cx = self.core_dims

        @jax.jit
        def f(out, vlo, vhi, thr):
            from flypylib_tpu.ops.nms import mask_valid_region

            prob = out[:vz, :vy, :vx]
            prob, _ = mask_valid_region(prob, vlo, vhi)
            corep = jax.lax.slice(
                prob, (h, h, h), (h + cz, h + cy, h + cx)
            )
            return self._cc_core_export(corep, thr, K, F)

        cache = getattr(self, "_cc_cache", None)
        if cache is None:
            cache = self._cc_cache = {}
        cache[(K, F)] = f
        return f

    def _cc_sparse_fn(self, C: int):
        """Sparse CC extraction: compact ALL above-threshold core voxels
        to C (local flat index, prob) slots.  The synapse masks this
        detector targets are ~0.01-1% occupied, so shipping the candidate
        set (and running one exact host csgraph CC over the global union
        — ops.components.components_from_candidates) beats running dense
        label-propagation sweeps over every ROI; overflow grows C and
        retries, so dense masks stay exact too."""
        try:
            return self._cc_sparse_cache[C]
        except (AttributeError, KeyError):
            pass
        from flypylib_tpu.ops.components import compact_true_indices

        vz, vy, vx = self.pipe.vol_shape
        h = self.h
        cz, cy, cx = self.core_dims
        n = cz * cy * cx

        @jax.jit
        def f(out, vlo, vhi, thr):
            from flypylib_tpu.ops.nms import mask_valid_region

            prob = out[:vz, :vy, :vx]
            prob, _ = mask_valid_region(prob, vlo, vhi)
            corep = jax.lax.slice(
                prob, (h, h, h), (h + cz, h + cy, h + cx)
            ).reshape(-1)
            m = corep >= thr
            cap = min(C, n)
            idx = compact_true_indices(m, cap)
            v = idx < n
            probs = jnp.where(
                v, corep[jnp.minimum(idx, n - 1)], -jnp.inf
            )
            over = jnp.sum(m, dtype=jnp.int32) > cap
            return idx, probs, over

        cache = getattr(self, "_cc_sparse_cache", None)
        if cache is None:
            cache = self._cc_sparse_cache = {}
        cache[C] = f
        return f

    def _fused_sparse_fn(self, C: int):
        """Fused NMS + sparse-CC postprocess for ``method="both"`` with
        the sparse backend: ONE dispatch and ONE core compaction instead
        of two of each.

        NMS candidates (local max AND >= thr) are a subset of the CC
        candidate set (>= thr), so compacting the CC set and gathering a
        per-candidate "is local max" bit yields both lists.  Two further
        exact reductions: the max filter runs on core +/- window//2 only
        (suppression cannot reach farther into the core), and candidates
        are compacted over the core instead of the full prob region —
        the core slice of the candidate mask IS the host-side ownership
        filter (out-of-volume voxels are -inf-masked and fail the
        threshold).  One dispatch instead of two.

        ``fused_impl="nbr"`` is a measured-and-REJECTED alternative that
        resolves ``is_max`` sparsely — one XLA gather of each compacted
        candidate's (window-volume,) neighborhood, out-of-volume
        neighbors -inf'd by coordinate compare (a voxel equals its
        window max iff no neighbor is strictly larger — exact, plateau
        ties included; pinned on CPU in tests/test_large.py).  It
        deletes the dense max filter, but its (C, window^3) random
        gather lost to the fused separable reduce_window on the first
        platform (not yet measured on the GPU)."""
        impl = self.fused_impl
        try:
            return self._fused_cache[(C, impl)]
        except (AttributeError, KeyError):
            pass
        from flypylib_tpu.ops.components import compact_true_indices
        from flypylib_tpu.ops.nms import mask_valid_region, max_filter

        vz, vy, vx = self.pipe.vol_shape
        h = self.h
        cz, cy, cx = self.core_dims
        n = cz * cy * cx
        win = self.window
        lo_ext = [w // 2 for w in win]
        hi_ext = [w - 1 - w // 2 for w in win]

        @jax.jit
        def f_filter(out, vlo, vhi, thr):
            prob = out[:vz, :vy, :vx]
            prob, _ = mask_valid_region(prob, vlo, vhi)
            sub = jax.lax.slice(
                prob,
                (h - lo_ext[0], h - lo_ext[1], h - lo_ext[2]),
                (h + cz + hi_ext[0], h + cy + hi_ext[1],
                 h + cx + hi_ext[2]),
            )
            mf = max_filter(sub, win)
            cand = (sub == mf) & (sub >= thr)
            cand_core = jax.lax.slice(
                cand, tuple(lo_ext),
                (lo_ext[0] + cz, lo_ext[1] + cy, lo_ext[2] + cx),
            ).reshape(-1)
            corep = jax.lax.slice(
                prob, (h, h, h), (h + cz, h + cy, h + cx)
            ).reshape(-1)
            m = corep >= thr
            cap = min(C, n)
            idx = compact_true_indices(m, cap)
            v = idx < n
            safe = jnp.minimum(idx, n - 1)
            probs = jnp.where(v, corep[safe], -jnp.inf)
            is_max = jnp.where(v, cand_core[safe], False)
            over = jnp.sum(m, dtype=jnp.int32) > cap
            return idx, probs, is_max, over

        @jax.jit
        def f_nbr(out, vlo, vhi, thr):
            prob = out[:vz, :vy, :vx]
            flat = prob.reshape(-1)
            corep = jax.lax.slice(
                prob, (h, h, h), (h + cz, h + cy, h + cx)
            ).reshape(-1)
            zz = lax.broadcasted_iota(jnp.int32, (cz, cy, cx), 0) + h
            yy = lax.broadcasted_iota(jnp.int32, (cz, cy, cx), 1) + h
            xx = lax.broadcasted_iota(jnp.int32, (cz, cy, cx), 2) + h
            inb = (
                (zz >= vlo[0]) & (zz < vhi[0])
                & (yy >= vlo[1]) & (yy < vhi[1])
                & (xx >= vlo[2]) & (xx < vhi[2])
            ).reshape(-1)
            m = inb & (corep >= thr)
            cap = min(C, n)
            idx = compact_true_indices(m, cap)
            v = idx < n
            safe = jnp.minimum(idx, n - 1)
            probs = jnp.where(v, corep[safe], -jnp.inf)
            czi = safe // (cy * cx) + h
            rem = safe % (cy * cx)
            cyi = rem // cx + h
            cxi = rem % cx + h
            offs = jnp.stack(
                jnp.meshgrid(
                    jnp.arange(-lo_ext[0], hi_ext[0] + 1),
                    jnp.arange(-lo_ext[1], hi_ext[1] + 1),
                    jnp.arange(-lo_ext[2], hi_ext[2] + 1),
                    indexing="ij",
                ),
                axis=-1,
            ).reshape(-1, 3).astype(jnp.int32)
            nz = czi[:, None] + offs[None, :, 0]
            ny = cyi[:, None] + offs[None, :, 1]
            nx = cxi[:, None] + offs[None, :, 2]
            nval = flat[((nz * vy + ny) * vx + nx).reshape(-1)].reshape(
                nz.shape
            )
            ninb = (
                (nz >= vlo[0]) & (nz < vhi[0])
                & (ny >= vlo[1]) & (ny < vhi[1])
                & (nx >= vlo[2]) & (nx < vhi[2])
            )
            nval = jnp.where(ninb, nval, -jnp.inf)
            is_max = v & jnp.all(nval <= probs[:, None], axis=1)
            over = jnp.sum(m, dtype=jnp.int32) > cap
            return idx, probs, is_max, over

        f = f_nbr if impl == "nbr" else f_filter

        cache = getattr(self, "_fused_cache", None)
        if cache is None:
            cache = self._fused_cache = {}
        cache[(C, impl)] = f
        return f

    # ---- shared whole-volume forward mode --------------------------------
    #
    # detect_staged's per-ROI forwards recompute each ROI's NMS-halo shell
    # ((core+2h)^3 / core^3 = 1.10x at core 512 for conv stacks) and, for
    # pooling models, pay covering-tile redundancy per ROI (2.5x at 1k^3).
    # When the volume fits an HBM budget, forward the WHOLE volume once
    # (one cost-optimal tile grid — monolithic semantics by the pinned
    # tiled==monolithic invariant), pad the prob map with a -inf shell
    # (exactly mask_valid_region's out-of-volume rule, applied once), and
    # run each ROI's postprocess as a traced-corner window over the shared
    # map.  Detections match the per-ROI mode / host reference exactly
    # (f32; test-pinned) — forward redundancy just disappears.

    # activation high-water of the packed U-Net forward per input voxel
    # (from a compiled memory_analysis of a 388^3 tile on the first
    # platform; chip_smoke.py prints the GPU's); sizes the
    # shared grid's activations for cover-regime models.  Override per
    # plan for custom models.
    act_bytes_per_voxel: float = 153.0

    def full_pipe(self, staged_bytes: int | None = None) -> DetectPipeline:
        """Whole-volume forward pipeline for the shared mode (lazy, one
        per plan; postprocess is never compiled on it).

        ``staged_bytes`` is accepted for call-site symmetry with
        :meth:`shared_auto` but does NOT shrink the grid tile: cover
        grids use only the natural (size-cap-bounded) min-cost tile;
        when its activations don't fit, :meth:`shared_auto` falls back
        to the roi mode instead."""
        fp = getattr(self, "_fp", None)
        if fp is None:
            fp = self._fp = self._make_shared_pipe(self.shape)
        return fp

    def _make_shared_pipe(self, vol_shape) -> DetectPipeline:
        """Forward-only pipeline over ``vol_shape`` with the shared
        mode's tile policy (cost-minimal cover grid / default conv-stack
        grid; split-write for packed pooling models)."""
        from flypylib_tpu.infer.tiled import (
            grid_tiling_min_cost,
            tiling_regime,
        )

        spec = self.pipe.spec
        cover = tiling_regime(spec) == "cover"
        if cover:
            t_out, t_batch = grid_tiling_min_cost(spec, vol_shape)
        else:
            ext = max(vol_shape)
            t_out = _default_tile(ext, spec)
            t_batch = min(16, max(1, (ext // t_out) ** 2))
        # honor the caller's explicit make_stream_plan(tile_out=,
        # tile_batch=) in shared mode too; the policy default stays for
        # None, explicit shapes are the caller's responsibility
        if self.req_tile[0] is not None:
            t_out = min(int(self.req_tile[0]), max(vol_shape))
        if self.req_tile[1] is not None:
            t_batch = int(self.req_tile[1])
        return DetectPipeline(
            spec, self.pipe.variables, vol_shape=vol_shape,
            tile_out=t_out, tile_batch=t_batch, window=self.window,
            threshold=self.threshold, max_detections=1,
            run_cc=False, pre_padded=True,
            # packed pooling models: keep the pack/unpack relayouts
            # out of the multi-tile executables (split_write in
            # pipeline.py) — and bound per-dispatch footprints
            split_write=cover,
        )

    # ---- multi-device shared forward: z-band partition ------------------
    #
    # The shared forward composes with ``devices=`` by splitting the ROI
    # grid's z-rows into contiguous BANDS, one per device: each device
    # forwards only its band's sub-volume (plus the +-h NMS halo, so ROI
    # windows near band seams read real probs) into its own local -inf
    # shell, and each ROI's postprocess runs on the device owning its
    # band.  Cores are disjoint and every prob voxel is computed with
    # monolithic semantics (the band's tile grid anchors at
    # band_z0 - h, which for pooling models is ==0 mod size_multiple
    # because core and h are both snapped — the pooling phase is
    # preserved), so detections are bit-identical to the single-device
    # modes (test-pinned).

    def _band_partition(self, n_devices: int):
        """``(rows_per_band, n_bands, band_z0s)`` splitting the grid's
        z-rows across ``n_devices``.  Bands are uniform (rows_per_band
        rows each) so ONE band pipeline serves every device; the last
        band SHIFTS DOWN to keep the uniform extent when the row count
        doesn't divide (its shell overlaps the previous band's — the
        overlapping probs are recomputed identically, and each ROI is
        still postprocessed exactly once, on its own band)."""
        n_rows = len({c[0] for _, c in self.grid}) or 1
        nb = max(1, min(int(n_devices), n_rows))
        rpb = -(-n_rows // nb)  # ceil
        b0s = self._band_starts(rpb)
        return rpb, len(b0s), b0s

    def _band_starts(self, rpb: int):
        """Band z0s (global voxel coords) for ``rpb`` rows per band, the
        last band shifted down to keep one uniform band extent."""
        cz = self.core_dims[0]
        n_rows = len({c[0] for _, c in self.grid}) or 1
        nb = -(-n_rows // rpb)
        return [min(i * rpb, n_rows - rpb) * cz for i in range(nb)]

    def band_pipe(self, rows_per_band: int) -> DetectPipeline:
        """Forward pipeline for one z-band (cached per band extent)."""
        cache = getattr(self, "_band_pipes", None)
        if cache is None:
            cache = self._band_pipes = {}
        fp = cache.get(rows_per_band)
        if fp is None:
            cz = self.core_dims[0]
            bz = rows_per_band * cz + 2 * self.h
            fp = cache[rows_per_band] = self._make_shared_pipe(
                (bz, self.shape[1], self.shape[2])
            )
        return fp

    def _shell_ext(self):
        """Per-axis high-side -inf slack so every ROI window slice of the
        shell stays in bounds (the last ROI's core box may overhang a
        non-divisible volume)."""
        return [
            max(
                0,
                max(c[d] for _, c in self.grid) + self.core_dims[d] - s,
            )
            for d, s in enumerate(self.shape)
        ]

    def _shell_shape(self):
        """Shell dims: volume + h low halo + max(h + ROI-overhang slack,
        forward grid extension) high side — big enough for both every
        ROI window slice and the forward's direct in-shell tile writes
        (grid-extension tiles land inside and are re-masked to -inf)."""
        h = self.h
        os_ = self.full_pipe()._out_shape
        return tuple(
            max(s + 2 * h + e, h + o)
            for s, e, o in zip(self.shape, self._shell_ext(), os_)
        )

    def _shell_init_fn(self):
        f = getattr(self, "_shell_init_jit", None)
        if f is None:
            shp = self._shell_shape()

            @jax.jit
            def f():
                return jnp.full(shp, -jnp.inf, jnp.float32)

            self._shell_init_jit = f
        return f

    def _shell_mask_fn(self):
        """Donated in-place pass restoring -inf outside the true volume
        (the forward writes grid-extension/overhang tiles into the shell;
        their voxels are out-of-volume and must not become candidates —
        the same rule mask_valid_region applies per ROI, applied once)."""
        f = getattr(self, "_shell_mask_jit", None)
        if f is None:
            h = self.h
            vz, vy, vx = self.shape
            shp = self._shell_shape()

            @functools.partial(jax.jit, donate_argnums=(0,))
            def f(shell):
                zz = lax.broadcasted_iota(jnp.int32, shp, 0)
                yy = lax.broadcasted_iota(jnp.int32, shp, 1)
                xx = lax.broadcasted_iota(jnp.int32, shp, 2)
                inb = (
                    (zz >= h) & (zz < h + vz)
                    & (yy >= h) & (yy < h + vy)
                    & (xx >= h) & (xx < h + vx)
                )
                return jnp.where(inb, shell, -jnp.inf)

            self._shell_mask_jit = f
        return f

    def shared_prob(self, staged) -> jax.Array:
        """Forward the whole volume once from a staged upload (either
        form) straight INTO the -inf-shelled shared probability map (the
        shell is allocated first and donated through the slab writes, so
        the raw prob map and the shell never coexist in HBM — at 1k^3
        that is ~4.5 GB of peak headroom, the margin that lets the
        U-Net's tin-388 covering grid fit).

        Chunk-staged volumes keep their upload/compute overlap: each
        z-slab window is device-assembled from only the chunks it covers,
        so early slabs forward while later chunks are still on the wire."""
        fp = self.full_pipe()
        ctx = self.ctx
        tin = fp._tin
        _, py, px = fp.padded_shape
        if isinstance(staged, _StagedChunks):
            off = staged.halo - ctx
            if off < 0:
                raise ValueError(
                    f"staged halo {staged.halo} < context {ctx}"
                )
            fetch = staged.window
        else:
            big, halo = staged
            off = halo - ctx
            if off < 0:
                raise ValueError(f"staged halo {halo} < context {ctx}")
            z_top = max(zs for zs, _ in fp._slabs) + tin
            pad_hi = [
                max(0, off + p - s)
                for p, s in zip((z_top, py, px), big.shape)
            ]
            if any(pad_hi):
                # zero extension feeds only prob voxels outside the true
                # volume — all -inf'd by the shell before any use
                big = jnp.pad(big, [(0, p) for p in pad_hi])

            def fetch(start, size, b=big):
                return _slice_window(
                    b, jnp.asarray(start, jnp.int32), size=tuple(size)
                )

        slab_for = lambda zs: fetch(  # noqa: E731
            (off + zs, off, off), (tin, py, px)
        )
        # split-write mode fetches per-tile windows (bounded footprint)
        tile_for = (
            (lambda zs, c: fetch(
                (off + zs + int(c[0]), off + int(c[1]), off + int(c[2])),
                (tin, tin, tin),
            ))
            if fp._split_write
            else None
        )
        h = self.h
        shell = fp.forward_slabs(
            slab_for, out=self._shell_init_fn()(), offset=(h, h, h),
            tile_for=tile_for,
        )
        return self._shell_mask_fn()(shell)

    def _band_shell_shape(self, fp: DetectPipeline):
        """Shell dims for one z-band: the band's forward span (+grid
        overshoot) in z — shell index 0 sits at global ``band_z0 - h`` —
        and the single-device shell's y/x dims."""
        h = self.h
        _, sy, sx = self._shell_shape()
        return (
            max(fp.vol_shape[0], fp._out_shape[0]),
            max(sy, h + fp._out_shape[1]),
            max(sx, h + fp._out_shape[2]),
        )

    def _band_shell_init(self, fp: DetectPipeline, device):
        """Fresh -inf band shell committed to ``device``."""
        key = ("band_init", self._band_shell_shape(fp), device)
        cache = getattr(self, "_band_jits", None)
        if cache is None:
            cache = self._band_jits = {}
        f = cache.get(key)
        if f is None:
            from jax.sharding import SingleDeviceSharding

            shp = self._band_shell_shape(fp)

            @functools.partial(
                jax.jit, out_shardings=SingleDeviceSharding(device)
            )
            def f():
                return jnp.full(shp, -jnp.inf, jnp.float32)

            cache[key] = f
        return f()

    def _band_mask_fn(self, fp: DetectPipeline):
        """Donated -inf restore outside the true volume for a band shell.
        ``glo`` (traced) is the global z of shell index 0 (= band_z0 - h),
        so one executable serves every band."""
        key = ("band_mask", self._band_shell_shape(fp))
        cache = getattr(self, "_band_jits", None)
        if cache is None:
            cache = self._band_jits = {}
        f = cache.get(key)
        if f is None:
            h = self.h
            vz, vy, vx = self.shape
            shp = self._band_shell_shape(fp)

            @functools.partial(jax.jit, donate_argnums=(0,))
            def f(shell, glo):
                zz = lax.broadcasted_iota(jnp.int32, shp, 0) + glo
                yy = lax.broadcasted_iota(jnp.int32, shp, 1)
                xx = lax.broadcasted_iota(jnp.int32, shp, 2)
                inb = (
                    (zz >= 0) & (zz < vz)
                    & (yy >= h) & (yy < h + vy)
                    & (xx >= h) & (xx < h + vx)
                )
                return jnp.where(inb, shell, -jnp.inf)

            cache[key] = f
        return f

    def shared_prob_band(self, big, halo: int, b0: int,
                         fp: DetectPipeline, variables, device):
        """Forward ONE z-band of the volume into its local -inf shell on
        ``device``.  ``big`` is the (already padded, device-committed)
        staged volume; the band's probs span global z
        ``[b0 - h, b0 - h + band_extent)`` — the +-h halo beyond the
        band's cores gives seam-adjacent ROI windows real prob values,
        exactly the voxels the monolithic map holds there (same tile
        semantics; bitwise — test-pinned)."""
        h = self.h
        ctx = self.ctx
        tin = fp._tin
        _, py, px = fp.padded_shape
        off = halo - ctx
        off2 = off + b0 - h  # >= 0: halo >= h + ctx

        slab_for = lambda zs: _slice_window(  # noqa: E731
            big, jnp.asarray((off2 + zs, off, off), jnp.int32),
            size=(tin, py, px),
        )
        tile_for = (
            (lambda zs, c: _slice_window(
                big,
                jnp.asarray(
                    (off2 + zs + int(c[0]), off + int(c[1]),
                     off + int(c[2])),
                    jnp.int32,
                ),
                size=(tin, tin, tin),
            ))
            if fp._split_write
            else None
        )
        shell = fp.forward_slabs(
            slab_for, variables=variables,
            out=self._band_shell_init(fp, device), offset=(0, h, h),
            tile_for=tile_for,
        )
        return self._band_mask_fn(fp)(shell, jnp.int32(b0 - h))

    def shared_prob_band_local(self, W, b0: int, fp: DetectPipeline,
                               variables=None):
        """Forward ONE z-band from a band-LOCAL padded window into its
        -inf band shell (the out-of-core shared mode,
        :func:`detect_streaming` ``forward="shared"``).

        ``W`` is the band's prepared input, uploaded whole: index 0 sits
        at global ``(b0 - h - ctx, -ctx, -ctx)`` — exactly where
        :meth:`DetectPipeline.prepare` anchors the band volume — built
        host-side by a single reflect pad of the read window at the true
        volume faces plus zero grid-extension (bitwise the staged path's
        halo + extension).  Same slab/tile executables, same write
        order, same mask as :meth:`shared_prob_band` — probs are bitwise
        the staged shared-band map's (test-pinned).  ``variables``
        overrides the plan's params (pass a copy committed to ``W``'s
        device when fanning bands over several local chips); the shell
        and every dispatch follow ``W``'s device."""
        h = self.h
        tin = fp._tin
        _, py, px = fp.padded_shape
        device = next(iter(W.devices()))

        slab_for = lambda zs: _slice_window(  # noqa: E731
            W, jnp.asarray((zs, 0, 0), jnp.int32), size=(tin, py, px)
        )
        tile_for = (
            (lambda zs, c: _slice_window(
                W,
                jnp.asarray(
                    (zs + int(c[0]), int(c[1]), int(c[2])), jnp.int32
                ),
                size=(tin, tin, tin),
            ))
            if fp._split_write
            else None
        )
        shell = fp.forward_slabs(
            slab_for, variables=variables,
            out=self._band_shell_init(fp, device),
            offset=(0, h, h), tile_for=tile_for,
        )
        return self._band_mask_fn(fp)(shell, jnp.int32(b0 - h))

    def band_rpb(self, itemsize: int = 4, cost_gate: bool = True,
                 bytes_limit: int | None = None):
        """Rows-per-band for the out-of-core shared forward, or ``None``
        when no band fits (or, with ``cost_gate``, when the shared grid
        wouldn't actually cut conv voxels vs the per-ROI sweep).

        Picks the LARGEST rows-per-band whose peak device memory fits
        ``bytes_limit`` (default
        :func:`~flypylib_tpu.utils.memory.device_bytes_limit`): fewer
        bands mean fewer z-seam halo re-forwards and fewer dispatches.
        The budget holds TWO band shells (the previous band's
        postprocess dispatches may still be in flight when the next
        band's forward dispatches) + two band input windows (one
        computing, one uploading behind it) + forward activations."""
        from flypylib_tpu.infer.tiled import tiling_regime
        from flypylib_tpu.utils.memory import device_bytes_limit

        if bytes_limit is None:
            bytes_limit = device_bytes_limit()
        n_rows = len({c[0] for _, c in self.grid}) or 1
        cover = tiling_regime(self.pipe.spec) == "cover"
        for rpb in range(n_rows, 0, -1):
            nb = -(-n_rows // rpb)
            if -(-n_rows // nb) != rpb:
                continue  # non-canonical count: nb bands rebalance lower
            fp = self.band_pipe(rpb)
            shell = 4 * int(np.prod(self._band_shell_shape(fp)))
            z_top = max(zs for zs, _ in fp._slabs) + fp._tin
            _, py, px = fp.padded_shape
            wbytes = int(itemsize) * z_top * py * px
            act = (
                int(self.act_bytes_per_voxel * fp._tin**3)
                if cover
                else _CONV_STACK_ACT_BYTES
            )
            if 2 * shell + 2 * wbytes + act + _SLACK_BYTES > bytes_limit:
                continue
            if cost_gate:
                # reward gate (BOTH regimes): the roi sweep hides its
                # reads/uploads behind compute via per-ROI prefetch, so
                # shared must buy a real conv-voxel cut to win.  Cover
                # grids (~2.5x per-ROI overlap at 1k^3) pass easily;
                # conv-stack grids at production cores save only
                # ~6-12% and would lose the overlap, so they stay roi
                # (a rule from the first platform, not yet re-measured
                # on the GPU).
                n_sh = nb * sum(
                    local.shape[0] * local.shape[1]
                    for _, local in fp._slabs
                )
                n_roi = sum(
                    local.shape[0] * local.shape[1]
                    for _, local in self.pipe._slabs
                )
                cost_sh = n_sh * fp._tin**3
                cost_roi = len(self.grid) * n_roi * self.pipe._tin**3
                if cost_sh > 0.85 * cost_roi:
                    return None
            return rpb
        return None

    def consume_shared_stream(self, shell_for, rpb: int, progress=None,
                              n_devices: int = 1):
        """:meth:`consume_shared` over LAZILY built per-band shells (the
        out-of-core shared mode): ``shell_for(band, b0)`` runs once per
        band, in grid z-row order, when the band's first ROI dispatches.
        The previous band's shell reference drops as soon as its last
        ROI postprocess has DISPATCHED (in-order device execution frees
        it once those dispatches drain; saturation-retry closures keep
        it alive through their collection window), so at most ~two band
        shells are ever held PER DEVICE — the budget :meth:`band_rpb`
        sizes for.  With ``n_devices > 1`` (bands round-robined over
        chips by the caller) the dispatch-ahead window scales by the
        device count so every chip keeps its pipeline full.  Grid order
        is preserved, so the merge — and the detection ordering — is
        identical to the single-shell sweep."""
        from collections import deque

        b0s = self._band_starts(rpb)
        nb = len(b0s)
        self._all_locs, self._all_conf = [], []
        self._cc_rois = {}
        window = max(self.pipeline_window, 8) * max(1, int(n_devices))
        pend: deque = deque()
        shell = None
        for band in range(nb):
            entries = [
                (k, c) for k, c in self.grid
                if min(k[0] // rpb, nb - 1) == band
            ]
            if not entries:
                continue
            shell = shell_for(band, b0s[band])
            # coarsened postprocess boxes (band-restricted, so no box
            # crosses a band-shell boundary — see _shared_boxes)
            for key, corner, dims in self._shared_boxes(entries):
                local = (corner[0] - b0s[band], corner[1], corner[2])
                pend.append(
                    self._dispatch_shared(key, corner, shell,
                                          corner_local=local, dims=dims)
                )
                if len(pend) >= window:
                    self._collect(pend.popleft(), progress)
        shell = None
        while pend:
            self._collect(pend.popleft(), progress)
        return self._finalize()

    def shared_auto(self, staged_bytes: int, n_devices: int = 1,
                    bytes_limit: int | None = None) -> bool:
        """True when the shared forward's peak device memory (the -inf
        shell the tiles write into + forward activations + the staged
        volume) fits ``bytes_limit`` (default
        :func:`~flypylib_tpu.utils.memory.device_bytes_limit`).  With
        ``n_devices > 1`` the estimate is per device: each device holds
        one z-band's shell (plus the replicated staged volume)."""
        from flypylib_tpu.infer.tiled import tiling_regime
        from flypylib_tpu.utils.memory import device_bytes_limit

        if bytes_limit is None:
            bytes_limit = device_bytes_limit()
        if n_devices > 1:
            rpb, _, _ = self._band_partition(n_devices)
            fp = self.band_pipe(rpb)
            shell = 4 * int(np.prod(self._band_shell_shape(fp)))
        else:
            fp = self.full_pipe(staged_bytes=int(staged_bytes))
            shell = 4 * int(np.prod(self._shell_shape()))
        if tiling_regime(self.pipe.spec) == "cover":
            # split-write forward: the grid tile is the natural
            # min-cost cover tile (full_pipe); its activations follow
            # the act model, so the gate rejects volumes whose shell +
            # staged bytes + tile activations bust the budget
            act = int(self.act_bytes_per_voxel * fp._tin**3)
            # ... and only go shared when the grid actually cuts conv
            # voxels vs the per-ROI sweep — a grid that merely matches
            # roi cost buys nothing
            n_sh = sum(
                local.shape[0] * local.shape[1] for _, local in fp._slabs
            )
            if n_devices > 1:  # whole-volume total = one grid per band
                n_sh *= self._band_partition(n_devices)[1]
            n_roi = sum(
                local.shape[0] * local.shape[1]
                for _, local in self.pipe._slabs
            )
            cost_sh = n_sh * fp._tin**3
            cost_roi = len(self.grid) * n_roi * self.pipe._tin**3
            if cost_sh > 0.85 * cost_roi:
                return False
        else:
            act = _CONV_STACK_ACT_BYTES
        peak = shell + act + int(staged_bytes) + _SLACK_BYTES
        return peak <= bytes_limit

    def _shared_boxes(self, entries=None):
        """The postprocess partition for the shared (monolithic-shell)
        sweep: the base ROI grid, COARSENED by grouping consecutive
        core rows into ~512-extent boxes.

        In shared mode the forward cost is core-independent (one
        whole-volume forward into the shell), so the per-ROI fixed
        postprocess cost is pure overhead: at the 1k^3 U-Net the
        default core-256 grid runs 64 per-ROI postprocesses where a
        512-box partition runs 8 — detections identical.  Boxes are
        disjoint unions of consecutive base cores (the last group takes the
        remainder rows), so coverage — and with it the candidate set,
        the -inf boundary rule, and the sorted merge — is exactly the
        base grid's.  The device-CC backend keeps the base grid (its
        seam face exports are sized by ``core_dims``); sparse CC and
        NMS are partition-free.

        Returns ``[(key, corner, dims)]``; ``dims`` keys the compiled
        postprocess variants (at most 2 distinct extents per axis).

        ``entries`` restricts the partition to a subset of the base
        grid (the band paths pass one band's rows, so no box ever
        crosses a band-shell boundary); it must be a full sub-grid
        (every z-row carries the same y/x corners — true of z-row
        bands by construction)."""
        grid = self.grid if entries is None else entries
        base = [(k, c, tuple(self.core_dims)) for k, c in grid]
        if not grid or (self.want_cc and self.cc_impl == "device"):
            return base
        target = getattr(self, "shared_box_target", 512)
        ks = [max(1, target // c) for c in self.core_dims]
        if all(k == 1 for k in ks):
            return base
        starts = [
            sorted({c[d] for _, c in grid}) for d in range(3)
        ]
        # coverage extent per axis (shell is sized for it)
        ext = [s[-1] + cd for s, cd in zip(starts, self.core_dims)]
        boxes = []
        for d in range(3):
            grp = [
                starts[d][i : i + ks[d]]
                for i in range(0, len(starts[d]), ks[d])
            ]
            boxes.append([
                (g[0], min(g[-1] + self.core_dims[d], ext[d]) - g[0])
                for g in grp
            ])
        # the key doubles as the _cc_rois dict key: use the (globally
        # unique) corner so band-restricted partitions never collide
        return [
            ((z0, y0, x0), (z0, y0, x0), (dz, dy, dx))
            for z0, dz in boxes[0]
            for y0, dy in boxes[1]
            for x0, dx in boxes[2]
        ]

    def _fused_shared_fn(self, C: int, dims=None):
        """Fused NMS + sparse-CC postprocess over a traced-corner window
        of the shared shell (no masking needed: out-of-volume voxels are
        -inf in the shell itself — same rule, applied once)."""
        dims = tuple(dims or self.core_dims)
        try:
            return self._fused_shared_cache[(C, dims)]
        except (AttributeError, KeyError):
            pass
        from flypylib_tpu.ops.components import compact_true_indices
        from flypylib_tpu.ops.nms import max_filter

        h = self.h
        cz, cy, cx = dims
        n = cz * cy * cx
        win = self.window
        lo_ext = [w // 2 for w in win]
        hi_ext = [w - 1 - w // 2 for w in win]
        sub_shape = (
            cz + lo_ext[0] + hi_ext[0],
            cy + lo_ext[1] + hi_ext[1],
            cx + lo_ext[2] + hi_ext[2],
        )

        @jax.jit
        def f(shell, corner, thr):
            sub = lax.dynamic_slice(
                shell,
                (
                    corner[0] + h - lo_ext[0],
                    corner[1] + h - lo_ext[1],
                    corner[2] + h - lo_ext[2],
                ),
                sub_shape,
            )
            mf = max_filter(sub, win)
            cand = (sub == mf) & (sub >= thr)
            cand_core = lax.slice(
                cand, tuple(lo_ext),
                (lo_ext[0] + cz, lo_ext[1] + cy, lo_ext[2] + cx),
            ).reshape(-1)
            corep = lax.slice(
                sub, tuple(lo_ext),
                (lo_ext[0] + cz, lo_ext[1] + cy, lo_ext[2] + cx),
            ).reshape(-1)
            m = corep >= thr
            cap = min(C, n)
            idx = compact_true_indices(m, cap)
            v = idx < n
            safe = jnp.minimum(idx, n - 1)
            probs = jnp.where(v, corep[safe], -jnp.inf)
            is_max = jnp.where(v, cand_core[safe], False)
            over = jnp.sum(m, dtype=jnp.int32) > cap
            return idx, probs, is_max, over

        cache = getattr(self, "_fused_shared_cache", None)
        if cache is None:
            cache = self._fused_shared_cache = {}
        cache[(C, dims)] = f
        return f

    def _nms_shared_fn(self, K: int, dims=None):
        """NMS-only postprocess over a shared-shell window: compacts the
        (local max AND >= thr) core candidates to K slots."""
        dims = tuple(dims or self.core_dims)
        try:
            return self._nms_shared_cache[(K, dims)]
        except (AttributeError, KeyError):
            pass
        from flypylib_tpu.ops.components import compact_true_indices
        from flypylib_tpu.ops.nms import max_filter

        h = self.h
        cz, cy, cx = dims
        n = cz * cy * cx
        win = self.window
        lo_ext = [w // 2 for w in win]
        hi_ext = [w - 1 - w // 2 for w in win]
        sub_shape = (
            cz + lo_ext[0] + hi_ext[0],
            cy + lo_ext[1] + hi_ext[1],
            cx + lo_ext[2] + hi_ext[2],
        )

        @jax.jit
        def f(shell, corner, thr):
            sub = lax.dynamic_slice(
                shell,
                (
                    corner[0] + h - lo_ext[0],
                    corner[1] + h - lo_ext[1],
                    corner[2] + h - lo_ext[2],
                ),
                sub_shape,
            )
            mf = max_filter(sub, win)
            cand = (sub == mf) & (sub >= thr)
            cand_core = lax.slice(
                cand, tuple(lo_ext),
                (lo_ext[0] + cz, lo_ext[1] + cy, lo_ext[2] + cx),
            ).reshape(-1)
            corep = lax.slice(
                sub, tuple(lo_ext),
                (lo_ext[0] + cz, lo_ext[1] + cy, lo_ext[2] + cx),
            ).reshape(-1)
            cap = min(K, n)
            idx = compact_true_indices(cand_core, cap)
            v = idx < n
            safe = jnp.minimum(idx, n - 1)
            conf = jnp.where(v, corep[safe], -jnp.inf)
            over = jnp.sum(cand_core, dtype=jnp.int32) > cap
            return idx, conf, over

        cache = getattr(self, "_nms_shared_cache", None)
        if cache is None:
            cache = self._nms_shared_cache = {}
        cache[(K, dims)] = f
        return f

    def _cc_sparse_shared_fn(self, C: int, dims=None):
        """Sparse-CC candidate compaction over a shared-shell core box."""
        dims = tuple(dims or self.core_dims)
        try:
            return self._cc_sparse_shared_cache[(C, dims)]
        except (AttributeError, KeyError):
            pass
        from flypylib_tpu.ops.components import compact_true_indices

        h = self.h
        cz, cy, cx = dims
        n = cz * cy * cx

        @jax.jit
        def f(shell, corner, thr):
            corep = lax.dynamic_slice(
                shell,
                (corner[0] + h, corner[1] + h, corner[2] + h),
                (cz, cy, cx),
            ).reshape(-1)
            m = corep >= thr
            cap = min(C, n)
            idx = compact_true_indices(m, cap)
            v = idx < n
            probs = jnp.where(
                v, corep[jnp.minimum(idx, n - 1)], -jnp.inf
            )
            over = jnp.sum(m, dtype=jnp.int32) > cap
            return idx, probs, over

        cache = getattr(self, "_cc_sparse_shared_cache", None)
        if cache is None:
            cache = self._cc_sparse_shared_cache = {}
        cache[(C, dims)] = f
        return f

    def _cc_shared_fn(self, K: int, F: int):
        """Device-CC label/extract over a shared-shell core box (same
        export body as the per-ROI extractor)."""
        try:
            return self._cc_shared_cache[(K, F)]
        except (AttributeError, KeyError):
            pass
        h = self.h
        cz, cy, cx = self.core_dims

        @jax.jit
        def f(shell, corner, thr):
            corep = lax.dynamic_slice(
                shell,
                (corner[0] + h, corner[1] + h, corner[2] + h),
                (cz, cy, cx),
            )
            return self._cc_core_export(corep, thr, K, F)

        cache = getattr(self, "_cc_shared_cache", None)
        if cache is None:
            cache = self._cc_shared_cache = {}
        cache[(K, F)] = f
        return f

    def _dispatch_shared(self, key, corner, shell, corner_local=None,
                         dims=None):
        """Dispatch one ROI's postprocess over ``shell``.  ``corner`` is
        the ROI's GLOBAL core corner (used by :meth:`_collect` to
        globalize detections); ``corner_local`` (band mode) is the same
        corner in the shell's own coordinates; ``dims`` (coarsened
        shared sweep) is the box extent when it differs from
        ``core_dims``."""
        cj = jnp.asarray(
            corner if corner_local is None else corner_local, jnp.int32
        )
        thr_j = jnp.float32(self.threshold)
        rec = {
            "key": key, "corner": corner, "lo_want": None, "out": None,
        }
        if dims is not None and tuple(dims) != tuple(self.core_dims):
            rec["dims"] = tuple(dims)
        # slot budgets stay UNSCALED for coarsened boxes: the per-ROI
        # device->host transfer is C (or K) slots whether or not they
        # are occupied, and over a slow host link those fixed bytes —
        # not the window compute — dominate the sweep.  Saturated
        # boxes self-heal via grow-and-retry, same as everywhere else.
        C0, K0 = self.C, self._nms_K
        fused = (
            self.want_nms and self.want_cc and self.cc_impl == "sparse"
            and getattr(self, "fuse_sparse", True)
            # the "nbr" fused impl is window-relative; shared mode falls
            # back to the (detection-identical) unfused dispatch pair
            and self.fused_impl == "filter"
        )
        res_all = []
        if fused:
            rerun = lambda C: self._fused_shared_fn(C, dims)(  # noqa: E731
                shell, cj, thr_j
            )
            rec["fused"] = rerun(C0)
            rec["cc_C"] = C0
            rec["rerun"] = rerun
            res_all.append(rec["fused"])
        else:
            if self.want_nms:
                rerun_n = lambda K: self._nms_shared_fn(K, dims)(  # noqa: E731
                    shell, cj, thr_j
                )
                rec["nms_sh"] = rerun_n(K0)
                rec["nms_K"] = K0
                rec["rerun_nms"] = rerun_n
                res_all.append(rec["nms_sh"])
            if self.want_cc:
                if self.cc_impl == "sparse":
                    rerun_c = lambda C: (  # noqa: E731
                        self._cc_sparse_shared_fn(C, dims)(
                            shell, cj, thr_j
                        )
                    )
                    rec["cc"] = rerun_c(C0)
                    rec["cc_C"] = C0
                else:
                    rerun_c = lambda K, F: (  # noqa: E731
                        self._cc_shared_fn(K, F)(shell, cj, thr_j)
                    )
                    rec["cc"] = rerun_c(self.K, self.F)
                    rec["cc_KF"] = (self.K, self.F)
                rec["rerun_cc"] = rerun_c
                res_all.append(rec["cc"])
        for leaf in jax.tree.leaves(res_all):
            leaf.copy_to_host_async()
        return rec

    def consume_shared(self, shell, progress=None):
        """Per-ROI postprocess sweep over the shared shell — same
        dispatch-ahead pipelining and merge as :meth:`consume`, but the
        in-flight buffers are tiny result arrays, not prob maps."""
        from collections import deque

        self._all_locs, self._all_conf = [], []
        self._cc_rois = {}
        window = max(self.pipeline_window, 8)
        pend: deque = deque()
        for key, corner, dims in self._shared_boxes():
            pend.append(
                self._dispatch_shared(key, corner, shell, dims=dims)
            )
            if len(pend) >= window:
                self._collect(pend.popleft(), progress)
        while pend:
            self._collect(pend.popleft(), progress)
        return self._finalize()

    def consume_shared_multi(self, shells, rpb: int, progress=None):
        """:meth:`consume_shared` over per-band shells: each ROI's
        postprocess dispatches on the device holding its band's shell
        (grid order is preserved, so the merge — and the detection
        ordering — is identical to the single-device sweep).  The
        dispatch-ahead window scales with the band count so every
        device keeps its pipeline full."""
        from collections import deque

        cz = self.core_dims[0]
        nb = len(shells)
        n_rows = len({c[0] for _, c in self.grid}) or 1
        self._all_locs, self._all_conf = [], []
        self._cc_rois = {}
        window = max(self.pipeline_window, 8) * nb
        pend: deque = deque()
        for band in range(nb):
            entries = [
                (k, c) for k, c in self.grid
                if min(k[0] // rpb, nb - 1) == band
            ]
            if not entries:
                continue
            b0 = min(band * rpb, n_rows - rpb) * cz
            # coarsened postprocess boxes (band-restricted, so no box
            # crosses a band-shell boundary — see _shared_boxes)
            for key, corner, dims in self._shared_boxes(entries):
                local = (corner[0] - b0, corner[1], corner[2])
                pend.append(
                    self._dispatch_shared(
                        key, corner, shells[band], corner_local=local,
                        dims=dims,
                    )
                )
                if len(pend) >= window:
                    self._collect(pend.popleft(), progress)
        while pend:
            self._collect(pend.popleft(), progress)
        return self._finalize()

    def _dense_faces(self, faces):
        """Rebuild dense face label planes from the sparse export (host
        side; merge_component_fragments consumes dense planes)."""
        cz, cy, cx = self.core_dims
        sentinel = cz * cy * cx
        shapes = [(cy, cx), (cy, cx), (cz, cx), (cz, cx), (cz, cy),
                  (cz, cy)]
        dense = []
        for (idx, labs), shp in zip(faces, shapes):
            d = np.full(shp[0] * shp[1], sentinel, np.int32)
            idx = np.asarray(idx)
            labs = np.asarray(labs)
            v = idx < d.size
            d[idx[v]] = labs[v]
            dense.append(d.reshape(shp))
        return dense

    def consume(self, outs, progress=None):
        """Drain an iterator of ``(key, corner, out_device, lo_want, vlo,
        vhi)`` and merge per-ROI results.

        Deep-pipelined: each ROI's postprocess is DISPATCHED immediately
        (its result arrays start copying to the host asynchronously) and
        COLLECTED ``pipeline_window`` ROIs later, so the host never
        blocks a device round-trip while the device still has queued
        forwards — per-ROI wire latency rides entirely under compute.
        The window bounds in-flight prob-map buffers (one per
        uncollected ROI; the map reference is kept until collection so a
        saturation grow-and-retry reruns only the postprocess, never the
        forward).
        """
        from collections import deque

        self._all_locs, self._all_conf = [], []
        self._cc_rois: dict[tuple, dict] = {}
        window = self.pipeline_window
        pend: deque = deque()
        for item in outs:
            pend.append(self._dispatch(*item))
            # >=: at most ``window`` ROIs (each holding a prob-map
            # buffer) are ever in flight — matching the HBM budget
            # ``pipeline_window`` was sized for
            if len(pend) >= window:
                self._collect(pend.popleft(), progress)
        while pend:
            self._collect(pend.popleft(), progress)
        return self._finalize()

    def _dispatch(self, key, corner, out, lo_want, vlo, vhi):
        rec = {
            "key": key, "corner": corner, "lo_want": lo_want,
            "vlo": vlo, "vhi": vhi, "out": out,
        }
        lo_j = jnp.asarray(vlo, jnp.int32)
        hi_j = jnp.asarray(vhi, jnp.int32)
        thr_j = jnp.float32(self.threshold)
        fused = (
            self.want_nms and self.want_cc and self.cc_impl == "sparse"
            and getattr(self, "fuse_sparse", True)  # A/B escape hatch
        )
        if fused:
            # the rerun closure holds the prob-map reference, so a
            # saturation grow-and-retry reruns only the postprocess
            rerun = lambda C: self._fused_sparse_fn(C)(  # noqa: E731
                out, lo_j, hi_j, thr_j
            )
            res = rerun(self.C)
            for leaf in jax.tree.leaves(res):
                leaf.copy_to_host_async()
            rec["fused"] = res
            rec["cc_C"] = self.C
            rec["rerun"] = rerun
            return rec
        if self.want_nms:
            rec["nms"] = self.pipe.postprocess_start(out, vlo, vhi)
        if self.want_cc:
            if self.cc_impl == "sparse":
                rerun = lambda C: self._cc_sparse_fn(C)(  # noqa: E731
                    out, lo_j, hi_j, thr_j
                )
                cc = rerun(self.C)
                rec["cc_C"] = self.C
            else:
                rerun = lambda K, F: self._cc_fn(K, F)(  # noqa: E731
                    out, lo_j, hi_j, thr_j
                )
                cc = rerun(self.K, self.F)
                rec["cc_KF"] = (self.K, self.F)
            for leaf in jax.tree.leaves(cc):
                leaf.copy_to_host_async()
            rec["cc"] = cc
            rec["rerun_cc"] = rerun
        return rec

    def _collect(self, rec, progress):
        key, corner = rec["key"], rec["corner"]
        lo_want = rec["lo_want"]
        out = rec.pop("out")  # held so retries rerun post, not forward
        provider = lambda: out  # noqa: E731
        # coarsened shared boxes carry their own extent (see
        # _shared_boxes); everything else uses the plan's core
        core_dims = rec.get("dims", self.core_dims)
        shape, ctx = self.shape, self.ctx
        n_own = 0
        if "fused" in rec:
            C, res = rec["cc_C"], rec["fused"]
            while True:
                idx, probs, is_max, over = jax.device_get(res)
                if not bool(over):
                    break
                C *= 4
                self.C = max(self.C, C)  # later ROIs reuse the size
                res = rec["rerun"](C)
            cz, cy, cx = core_dims
            n = cz * cy * cx
            idx = np.asarray(idx, np.int64)
            v = idx < n
            idx = idx[v]
            probs = np.asarray(probs)[v]
            is_max = np.asarray(is_max)[v]
            # local core flat index -> global (z, y, x)
            gz = idx // (cy * cx) + corner[0]
            rem = idx % (cy * cx)
            gy = rem // cx + corner[1]
            gx = rem % cx + corner[2]
            glob = np.stack([gz, gy, gx], axis=1).astype(np.float64)
            self._all_locs.append(glob[is_max])
            self._all_conf.append(probs[is_max])
            n_own = int(is_max.sum())
            vz_g, vy_g, vx_g = self.shape
            self._cc_rois[key] = {
                "gflat": (gz * vy_g + gy) * vx_g + gx,
                "prob": probs,
            }
            if progress:
                progress(corner, n_own)
            return
        if "nms_sh" in rec:
            # shared-forward NMS: candidates were compacted over the core
            # on device (ownership by construction — out-of-volume shell
            # voxels are -inf and can't be candidates)
            K, res = rec["nms_K"], rec["nms_sh"]
            while True:
                idx, conf, over = jax.device_get(res)
                if not bool(over):
                    break
                K *= 4
                self._nms_K = max(self._nms_K, K)
                res = rec["rerun_nms"](K)
            cz, cy, cx = core_dims
            n = cz * cy * cx
            idx = np.asarray(idx, np.int64)
            v = idx < n
            idx = idx[v]
            conf = np.asarray(conf)[v]
            gz = idx // (cy * cx) + corner[0]
            rem = idx % (cy * cx)
            gy = rem // cx + corner[1]
            gx = rem % cx + corner[2]
            self._all_locs.append(
                np.stack([gz, gy, gx], axis=1).astype(np.float64)
            )
            self._all_conf.append(conf)
            n_own = int(v.sum())
        if "nms" in rec:
            # grow-and-retry via ``provider`` on saturation, so the
            # per-ROI list is always complete
            nms_det, _ = self.pipe.postprocess_finish(rec["nms"], provider)
            # local coords are relative to lo_want; prob index 0 is at
            # global lo_want + ctx
            glob = nms_det.locs + np.asarray(
                [v + ctx for v in lo_want], np.float64
            )
            own = np.all(
                (glob >= np.asarray(corner))
                & (
                    glob
                    < np.minimum(
                        np.asarray(corner) + core_dims, np.asarray(shape)
                    )
                ),
                axis=1,
            )
            self._all_locs.append(glob[own])
            self._all_conf.append(nms_det.conf[own])
            n_own = int(own.sum())
        if "cc" in rec and self.cc_impl == "sparse":
            C, res = rec["cc_C"], rec["cc"]
            while True:
                idx, probs, over = jax.device_get(res)
                if not bool(over):
                    break
                C *= 4
                self.C = max(self.C, C)  # later ROIs reuse the size
                res = rec["rerun_cc"](C)
            cz, cy, cx = core_dims
            n = cz * cy * cx
            idx = np.asarray(idx, np.int64)
            v = idx < n
            idx = idx[v]
            probs = np.asarray(probs)[v]
            # local core coords -> global flat indices (int64)
            gz = idx // (cy * cx) + corner[0]
            rem = idx % (cy * cx)
            gy = rem // cx + corner[1]
            gx = rem % cx + corner[2]
            vz_g, vy_g, vx_g = self.shape
            self._cc_rois[key] = {
                "gflat": (gz * vy_g + gy) * vx_g + gx,
                "prob": probs,
            }
        elif "cc" in rec:
            (K, F), res = rec["cc_KF"], rec["cc"]
            while True:
                # ONE bulk device->host transfer per ROI (each array
                # would otherwise cost its own roundtrip)
                uniq, sums, count, conf, valid, over_k, over_f, faces = (
                    jax.device_get(res)
                )
                if not (bool(over_k) or bool(over_f)):
                    break
                # grow only the saturated capacity: each distinct (K, F)
                # is a fresh XLA compile
                if bool(over_k):
                    K *= 4
                    self.K = max(self.K, K)  # later ROIs reuse the sizes
                if bool(over_f):
                    F *= 4
                    self.F = max(self.F, F)
                res = rec["rerun_cc"](K, F)
            sums = np.asarray(sums, np.float64)
            count = np.asarray(count, np.float64)
            # globalize coordinate sums by the core's corner
            sums += np.asarray(corner, np.float64) * count[:, None]
            self._cc_rois[key] = {
                "uniq": uniq,
                "sums": sums,
                "count": count,
                "conf": conf,
                "valid": valid,
                "faces": self._dense_faces(faces),
            }
        if progress:
            progress(corner, n_own)

    def _finalize(self):
        results = []
        if self.want_nms:
            if self._all_locs:
                results.append(sort_detections(
                    np.concatenate(self._all_locs),
                    np.concatenate(self._all_conf),
                ))
            else:
                results.append(
                    Tbars(locs=np.zeros((0, 3)), conf=np.zeros((0,)))
                )
        if self.want_cc and self.cc_impl == "sparse":
            from flypylib_tpu.ops.components import (
                components_from_candidates,
            )

            if self._cc_rois:
                gflat = np.concatenate(
                    [r["gflat"] for r in self._cc_rois.values()]
                )
                probs = np.concatenate(
                    [r["prob"] for r in self._cc_rois.values()]
                )
                order = np.argsort(gflat)
                results.append(components_from_candidates(
                    gflat[order], probs[order], self.shape
                ))
            else:
                results.append(
                    Tbars(locs=np.zeros((0, 3)), conf=np.zeros((0,)))
                )
        elif self.want_cc:
            from flypylib_tpu.ops.components import (
                merge_component_fragments,
            )

            cz, cy, cx = self.core_dims
            results.append(
                merge_component_fragments(self._cc_rois, cz * cy * cx)
            )
        if self.method == "both":
            return tuple(results)
        return results[0]


def _default_core(
    spec: ModelSpec, window, grid_default: int, shape=None
) -> int:
    """Model-aware default ROI core.  Pooling topologies take the core
    that minimizes total processed voxels (ROI grid count x covering
    tile volume) subject to the tile-input size cap (428, inherited
    from the first platform's compiler): bigger cores shrink per-ROI halo
    redundancy but a core that divides the volume badly multiplies the
    ROI count (e.g. at 1k^3 the cap-maximal core 336 needs a 4^3 grid
    of 428-tiles = 4.7x redundancy, while core 256 is 2.5x).  Conv
    stacks keep the grid default (their per-ROI postprocess/forward
    trade was swept at core 128-512 on the first platform)."""
    from flypylib_tpu.infer.tiled import tiling_regime
    from flypylib_tpu.utils import round_up

    if tiling_regime(spec) != "cover":
        return grid_default
    ctx = spec.context
    mult = max(spec.size_multiple, 1)
    # mirror _StreamPlan's pooled geometry exactly: phase-aligned halo,
    # core snapped to the pooling stride
    h = round_up(ctx + max(to3d(window)) // 2, mult)
    over = 2 * (h + ctx)
    max_core = (428 - over) // mult * mult
    while max_core > mult and spec.valid_size(max_core + over) > 428:
        max_core -= mult
    if shape is None:
        return max(max_core, mult)
    dims = to3d(shape)
    best, best_cost = max_core, float("inf")
    for core in range(mult, max_core + 1, mult):
        tin = spec.valid_size(min(core, max(dims)) + over)
        cost = tin**3
        for d in dims:
            cost *= -(-d // min(core, d))
        # prefer the larger core on ties (fewer ROIs = fewer dispatches)
        if cost <= best_cost:
            best, best_cost = core, cost
    return best


def make_stream_plan(
    spec: ModelSpec,
    variables,
    shape,
    core: int | None = None,
    tile_out: int | None = None,
    tile_batch: int | None = None,
    window=5,
    threshold: float = 0.5,
    max_detections_per_roi: int = 4096,
    max_components_per_roi: int = 4096,
    method: str = "nms",
    cc_impl: str = "sparse",
    fused_impl: str = "filter",
):
    """Build the reusable streaming-detection engine (ROI grid + compiled
    pipelines) for :func:`detect_streaming` / :func:`detect_staged`.

    ``core`` is the ROI ownership box: an int (cubic) or a ``(z, y, x)``
    triple — anisotropic cores reduce the ROI count (and with it the
    fixed per-ROI postprocess cost) without growing per-axis halo
    redundancy.  ``core=None`` picks a model-aware default: conv stacks
    get the measured grid default, pooling topologies the largest core
    whose ONE covering tile stays under the compile-size cap.  For
    pooling models the core and the NMS halo are snapped up to
    ``size_multiple`` so every ROI forward keeps the monolithic pooling
    phase (pooling nets are shift-equivariant only modulo the pooling
    stride; unaligned ROI anchors would silently change detections —
    test-pinned in tests/test_large.py).

    Reuse one plan across calls on same-shaped volumes: every fresh plan
    re-jits the tile forward and postprocess.  ``threshold`` is traced and may differ per call; the
    geometry arguments (shape/core/window/method/cc_impl) are baked in.

    ``cc_impl`` selects the components backend: ``"sparse"`` (default)
    ships each ROI's compacted candidate voxels and runs one exact host
    csgraph CC over the global union — work scales with candidate count,
    the right trade for ~0.01-1%-occupied synapse masks; ``"device"``
    runs dense label-propagation CC per ROI on device with a union-find
    seam merge — better for dense (e.g. membrane) masks.  Both are
    detection-exact vs ``scipy.ndimage.label`` (tests/test_large.py).

    ``fused_impl`` selects how the fused ``method="both"`` postprocess
    resolves each candidate's local-max bit: ``"filter"`` (default) runs
    the dense separable max filter; ``"nbr"`` gathers the compacted
    candidates' window neighborhoods — asymptotically cheaper (work
    scales with candidate count, not ROI volume) but it lost to the
    dense filter on the first platform (random gathers vs fused
    reduce_window; not yet measured on the GPU), so it is kept only as
    a documented alternative.  Detection-identical (both
    pinned vs the scipy host reference in tests/test_large.py).
    """
    if tile_out is not None and int(tile_out) < spec.size_multiple:
        raise ValueError(
            f"tile_out={tile_out} is below the model's size_multiple "
            f"({spec.size_multiple}); the tile forward cannot keep the "
            "pooling phase at that size"
        )
    if tile_batch is not None and int(tile_batch) < 1:
        raise ValueError(f"tile_batch must be >= 1, got {tile_batch}")
    if core is None:
        core = _default_core(spec, window, 128, shape)
    return _StreamPlan(
        spec, variables, shape, core, tile_out, tile_batch, window,
        threshold, max_detections_per_roi, max_components_per_roi, method,
        cc_impl, fused_impl,
    )


def _check_plan(plan, shape, window, method, threshold, cc_impl=None,
                core=None, tile_out=None, tile_batch=None):
    """Geometry args are baked into a plan; catch silent mismatches and
    retarget the traced threshold.  ``core``/``tile_out``/``tile_batch``
    are checked only when the caller passed them explicitly (non-None) —
    a plan silently overriding the caller's perf-relevant arguments would
    otherwise go unnoticed (results stay exact either way)."""
    if plan.shape != to3d(shape):
        raise ValueError(f"plan shape {plan.shape} != volume {to3d(shape)}")
    if plan.window != to3d(window):
        raise ValueError(f"plan window {plan.window} != {to3d(window)}")
    if plan.method != method:
        raise ValueError(f"plan method {plan.method!r} != {method!r}")
    if cc_impl is not None and plan.cc_impl != cc_impl:
        raise ValueError(
            f"plan cc_impl {plan.cc_impl!r} != {cc_impl!r}"
        )
    if core is not None and tuple(to3d(core)) != tuple(to3d(plan.core)):
        raise ValueError(f"plan core {plan.core} != caller core {core}")
    for name, want, have in (
        ("tile_out", tile_out, plan.req_tile[0]),
        ("tile_batch", tile_batch, plan.req_tile[1]),
    ):
        if want is not None and want != have:
            raise ValueError(
                f"plan {name} {have} != caller {name} {want} "
                "(rebuild the plan with the desired tiling)"
            )
    plan.threshold = threshold  # traced everywhere: no recompile
    plan.pipe.threshold = float(threshold)
    return plan


def detect_streaming(
    spec: ModelSpec,
    variables,
    shape,
    read_fn,
    core: int | None = None,
    tile_out: int | None = None,
    tile_batch: int | None = None,
    window=5,
    threshold: float = 0.5,
    max_detections_per_roi: int = 4096,
    max_components_per_roi: int = 4096,
    method: str = "nms",
    cc_impl: str = "sparse",
    progress=None,
    plan: "_StreamPlan | None" = None,
    forward: str = "auto",
    devices=None,
):
    """Exact streaming detection over an arbitrarily large volume.

    ``shape``/``read_fn`` typically come from :func:`h5_reader`.
    ``method`` is ``"nms"`` (local-maximum candidates), ``"components"``
    (seam-merged connected-component centroids), or ``"both"`` (returns a
    ``(nms, components)`` tuple).

    ``tile_out=None`` (default) picks the largest exact divisor of the
    ROI extent under a memory cap (:func:`_default_tile`): divisors keep
    the static tile grid from overshooting the ROI (a 272-wide ROI under
    non-dividing 256-wide tiles runs 8 tiles of 268^3 — 4.6x redundant
    conv FLOPs), and the cap bounds per-tile activation memory.

    ``plan`` (from :func:`make_stream_plan`) reuses the compiled engine
    across calls — each fresh plan re-jits the forward/postprocess, which
    costs minutes of XLA compile on repeated invocations.

    ``forward`` selects how probability maps are produced (the
    out-of-core analog of :func:`detect_staged`'s modes):

    * ``"roi"`` — each ROI fetches + forwards its own halo-padded block
      (bounded HBM and host memory, the most conservative mode);
    * ``"shared"`` — the volume is processed in z-BANDS of whole ROI
      rows: each band's input window is read once, forwarded once
      through the cost-optimal shared tile grid into a band-local
      -inf-shelled prob map, and the band's ROI postprocesses run as
      traced windows over it.  Deletes the per-ROI forward redundancy
      (covering-tile overlap ~2.5x for pooling models at 1k^3) AND the
      per-ROI host re-read of overlapping halo windows, while staying
      bounded: only ~two band shells + one band window are ever
      resident (:meth:`_StreamPlan.band_rpb`);
    * ``"auto"`` (default) — ``"shared"`` when a band height fits the
      device budget AND the banded grid cuts conv voxels by >15% vs the
      per-ROI sweep (covering-tile/pooling models at production cores;
      conv-stack grids save only ~6-12% and keep roi's prefetch
      overlap instead), else ``"roi"``.

    Detections are identical across modes — same monolithic-semantics
    probs (single reflect pad at the true volume faces), same
    postprocess, same merge order (pinned by
    tests/test_large.py::test_streaming_shared_*).

    ``devices`` (e.g. ``jax.local_devices()``) fans the out-of-core
    sweep over several local chips: roi mode round-robins the per-ROI
    forwards (params replicated once per device), shared mode
    round-robins whole z-bands (band height still sized for ONE chip's
    budget, split further so every device gets work when possible).
    The host-side read thread and the merge are unchanged, so
    detections stay bit-identical to the single-device sweep
    (tests/test_large.py::test_streaming_multi_device*).
    """
    if forward not in ("roi", "shared", "auto"):
        raise ValueError(f"unknown forward mode {forward!r}")
    multi = devices is not None and len(devices) > 1
    if plan is None:
        plan = make_stream_plan(
            spec, variables, shape,
            core=(_default_core(spec, window, 128, shape)
                  if core is None else core),
            tile_out=tile_out,
            tile_batch=tile_batch, window=window, threshold=threshold,
            max_detections_per_roi=max_detections_per_roi,
            max_components_per_roi=max_components_per_roi, method=method,
            cc_impl=cc_impl,
        )
    else:
        plan = _check_plan(plan, shape, window, method, threshold,
                           cc_impl, core, tile_out, tile_batch)
    shape = plan.shape
    pipe = plan.pipe
    fetch_halo = plan.fetch_halo
    core_dims = plan.core_dims

    if forward != "roi" and min(shape) > fetch_halo:
        # the band window's single reflect pad needs every pad amount
        # under the read extent; volumes at/below the fetch halo stay
        # on the roi path (prep() handles them ROI by ROI)
        probe = np.asarray(read_fn((0, 0, 0), (1, 1, 1)))
        itemsize = 1 if probe.dtype == np.uint8 else 4
        rpb = plan.band_rpb(itemsize=itemsize,
                            cost_gate=(forward == "auto"))
    else:
        rpb = None
    if forward == "shared" and rpb is None:
        raise ValueError(
            "shared streaming forward does not fit this chip/geometry "
            "(no band height passes the HBM budget, or the volume is "
            "smaller than the fetch halo); use forward='roi'"
        )
    logger.info("detect_streaming: forward=%s (requested %s), %d ROIs",
                "roi" if rpb is None else f"shared({rpb} rows/band)",
                forward, len(plan.grid))
    if rpb is not None:
        if multi:
            # split bands further (never beyond one chip's budget) so
            # every device gets work; _band_starts rebalances any rpb
            rpb = min(rpb, plan._band_partition(len(devices))[0])
        return _detect_streaming_shared(plan, read_fn, rpb, progress,
                                        devices if multi else None)

    def prep(corner):
        """Fetch + reflect-pad one ROI block (host work, prefetchable)."""
        lo_want, vlo, vhi = plan.region(corner)
        hi_want = [
            c + cd + fetch_halo for c, cd in zip(corner, core_dims)
        ]
        lo = [max(0, v) for v in lo_want]
        hi = [min(s, v) for s, v in zip(shape, hi_want)]
        block = np.asarray(read_fn(lo, hi))
        # ONE reflect pad continues the volume past its faces —
        # identical to a monolithic run's face padding
        pads = [
            (l - lw, hw - hh)
            for l, lw, hw, hh in zip(lo, lo_want, hi_want, hi)
        ]
        block = np.pad(block, pads, mode="reflect")
        return block, lo_want, vlo, vhi

    # prefetch thread: the next ROI's disk read + pad rides under the
    # current ROI's device time
    import queue as _queue
    import threading

    # prefetch depth: one block ahead single-device; enough to keep
    # every chip fed when the sweep round-robins over devices
    fetched: _queue.Queue = _queue.Queue(
        maxsize=(len(devices) + 1) if multi else 2
    )

    def producer():
        for key, corner in plan.grid:
            try:
                fetched.put((key, corner, prep(corner), None))
            except Exception as e:  # surface on the consumer side
                fetched.put((key, corner, None, e))
                return

    threading.Thread(target=producer, daemon=True).start()

    if multi:
        # round-robin the per-ROI forwards over the local chips: the
        # prepared block is committed whole to its device and forwarded
        # there with device-committed params (forward_from is bitwise
        # forward_staged on the same data — pinned); postprocess
        # dispatches follow the map's device, the merge is unchanged
        varss = [jax.device_put(pipe.variables, d) for d in devices]
        n = len(devices)
        window_save = plan.pipeline_window
        plan.pipeline_window = max(window_save * n, n + 1)
        try:

            def outs_multi():
                for i in range(len(plan.grid)):
                    key, corner, prepped, err = fetched.get()
                    if err is not None:
                        raise RuntimeError(
                            f"ROI {corner}: fetch failed"
                        ) from err
                    block, lo_want, vlo, vhi = prepped
                    j = i % n
                    big_j = jax.device_put(pipe.prepare(block), devices[j])
                    yield (
                        key, corner,
                        pipe.forward_from(big_j, (0, 0, 0),
                                          variables=varss[j]),
                        lo_want, vlo, vhi,
                    )

            return plan.consume(outs_multi(), progress)
        finally:
            plan.pipeline_window = window_save

    def outs():
        for _ in plan.grid:
            key, corner, prepped, err = fetched.get()
            if err is not None:
                raise RuntimeError(f"ROI {corner}: fetch failed") from err
            block, lo_want, vlo, vhi = prepped
            yield key, corner, pipe.forward(block), lo_want, vlo, vhi

    return plan.consume(outs(), progress)


def _band_window_np(plan, fp, read_fn, b0: int):
    """Host-side band input window for the out-of-core shared forward.

    Bitwise the slice the STAGED shared path's tiles read from the
    staged ``big`` array at global anchor ``(b0 - h - ctx, -ctx, -ctx)``:
    ``big`` is the volume reflect-padded by ``fetch_halo = h + ctx`` at
    every true face, zero grid-extension beyond — so the window reflects
    at most ``fetch_halo`` past a face and zero-fills the rest.  The full
    ``fetch_halo`` back-reflect matters: pooled (ConvTranspose) models
    have per-voxel parity reach beyond ``ctx``, so in-volume probs near
    a face genuinely read the ``[v, v + fetch_halo)`` reflect band
    (ctx-only reflect there changes detections — test-pinned)."""
    h, ctx = plan.h, plan.ctx
    fh = h + ctx  # == plan.fetch_halo
    vz, vy, vx = plan.shape
    z_top = max(zs for zs, _ in fp._slabs) + fp._tin
    _, py, px = fp.padded_shape
    zlo = b0 - h - ctx  # >= -fh, so the front reflect always fits
    clo, chi = max(0, zlo), min(vz, zlo + z_top)
    block = np.asarray(read_fn((clo, 0, 0), (chi, vy, vx)))
    if block.dtype != np.uint8:
        block = block.astype(np.float32)
    block = np.pad(
        block,
        [
            (clo - zlo, min(max(0, zlo + z_top - vz), fh)),
            (ctx, min(max(0, py - ctx - vy), fh)),
            (ctx, min(max(0, px - ctx - vx), fh)),
        ],
        mode="reflect",
    )
    return np.pad(
        block,
        [(0, z_top - block.shape[0]), (0, py - block.shape[1]),
         (0, px - block.shape[2])],
    )


def _detect_streaming_shared(plan, read_fn, rpb: int, progress,
                             devices=None):
    """Out-of-core shared forward: z-bands of whole ROI rows, each read
    once, forwarded once into a band shell, postprocessed per ROI.

    Each band window is the array :meth:`DetectPipeline.prepare` would
    produce for the band volume — read clipped to the true volume, ONE
    reflect pad continuing it past the faces (monolithic semantics; the
    same single-reflect rule as the roi path's ``prep``), zero
    grid-extension — so the band probs are bitwise the staged shared
    path's.  A prefetch thread reads band *i*+1 while band *i* forwards
    and postprocesses; at most two band shells + one uploaded window are
    resident PER DEVICE (:meth:`_StreamPlan.band_rpb`'s budget).  With
    ``devices`` the bands round-robin over the chips (params replicated
    once per device, each ROI postprocess dispatched on its band's
    device); grid order — and therefore the merge — is unchanged."""
    fp = plan.band_pipe(rpb)
    b0s = plan._band_starts(rpb)
    n = len(devices) if devices else 1
    varss = (
        [jax.device_put(plan.pipe.variables, d) for d in devices]
        if devices
        else None
    )

    def band_window(b0):
        return _band_window_np(plan, fp, read_fn, b0)

    import queue as _queue
    import threading

    # prefetch depth n: with several chips, up to n band windows ride
    # ahead so every device's forward can dispatch without waiting on
    # the (serial) host read thread
    fetched: _queue.Queue = _queue.Queue(maxsize=n)

    def producer():
        for b0 in b0s:
            try:
                fetched.put((band_window(b0), None))
            except Exception as e:  # surface on the consumer side
                fetched.put((None, e))
                return

    threading.Thread(target=producer, daemon=True).start()

    def shell_for(band, b0):
        W, err = fetched.get()
        if err is not None:
            raise RuntimeError(f"band z0={b0}: fetch failed") from err
        if devices:
            j = band % n
            return plan.shared_prob_band_local(
                jax.device_put(W, devices[j]), b0, fp,
                variables=varss[j],
            )
        return plan.shared_prob_band_local(jax.device_put(W), b0, fp)

    return plan.consume_shared_stream(shell_for, rpb, progress,
                                      n_devices=n)


def detect_staged(
    spec: ModelSpec,
    variables,
    volume: np.ndarray,
    core: int | None = None,
    tile_out: int | None = None,
    tile_batch: int | None = None,
    window=5,
    threshold: float = 0.5,
    max_detections_per_roi: int = 4096,
    max_components_per_roi: int = 4096,
    method: str = "nms",
    cc_impl: str = "sparse",
    progress=None,
    staged=None,
    plan: "_StreamPlan | None" = None,
    devices=None,
    forward: str = "auto",
):
    """HBM-resident streaming detection: the whole volume is staged on
    device ONCE (uint8 stays uint8 — 4x cheaper on the wire), then every
    ROI block is sliced device-to-device, so the steady state never
    touches the host wire.  This is the chip-bound operating mode for
    volumes that fit HBM (the 1k^3 north-star config [B:5][B:8]);
    detections are exactly :func:`detect_streaming`'s (same plan, same
    postprocess — pinned by tests/test_large.py).

    ``staged`` (from :func:`stage_volume`) reuses a previous upload
    across calls and ``plan`` (from :func:`make_stream_plan`) reuses the
    compiled engine — e.g. threshold sweeps on the same volume recompile
    and re-upload nothing.

    ``forward`` selects how probability maps are produced:

    * ``"roi"`` — each ROI runs its own halo-padded forward (bounded
      HBM);
    * ``"shared"`` — the WHOLE volume forwards once through a
      cost-optimal tile grid, writing straight into the -inf-shelled
      shared map, and every ROI's postprocess is a traced window over
      it.  Removes the per-ROI forward redundancy (halo shells for conv
      stacks, covering-tile overlap for pooling models — 2.5x at 1k^3
      for the U-Net) at the cost of holding the full shelled prob map
      on device;
    * ``"auto"`` (default) — ``"shared"`` when the peak device-memory
      estimate fits the budget (:meth:`_StreamPlan.shared_auto`), else
      ``"roi"``.

    Detections are identical across modes (same monolithic semantics;
    pinned by tests/test_large.py::test_staged_shared_forward_*).

    ``devices`` (e.g. ``jax.local_devices()``) fans the sweep over
    several local chips (eval config 5's per-host scale-up, [B:11];
    SURVEY.md section 2.3 SP row).  In roi mode the staged volume and
    params are replicated per device and ROIs round-robin across them;
    in shared mode the grid's z-rows split into contiguous BANDS, one
    per device, each forwarding its band (+-h halo) into a local -inf
    shell with per-band postprocess.  ROI cores are disjoint and the
    host-side merge is order-exact, so detections are bit-identical to
    the single-device sweep in both modes
    (tests/test_large.py::test_staged_multi_device_bit_identical,
    ::test_staged_shared_forward_multi_device).
    """
    if forward not in ("roi", "shared", "auto"):
        raise ValueError(f"unknown forward mode {forward!r}")
    if plan is None:
        plan = make_stream_plan(
            spec, variables, np.shape(volume),
            core=(_default_core(spec, window, 256, np.shape(volume))
                  if core is None else core),
            tile_out=tile_out, tile_batch=tile_batch, window=window,
            threshold=threshold,
            max_detections_per_roi=max_detections_per_roi,
            max_components_per_roi=max_components_per_roi, method=method,
            cc_impl=cc_impl,
        )
    else:
        plan = _check_plan(plan, np.shape(volume), window, method,
                           threshold, cc_impl, core, tile_out, tile_batch)
    if staged is None:
        staged = stage_volume(volume, plan=plan)
    multi = devices is not None and len(devices) > 1
    staged_bytes = (
        sum(c.nbytes for c in staged.chunks)
        if isinstance(staged, _StagedChunks)
        else staged[0].nbytes
    )
    shared = forward == "shared" or (
        forward == "auto"
        and plan.shared_auto(
            staged_bytes, n_devices=len(devices) if multi else 1
        )
    )
    logger.info("detect_staged: forward=%s (requested %s), %d ROIs, "
                "%d device(s)", "shared" if shared else "roi", forward,
                len(plan.grid), len(devices) if multi else 1)
    if shared:
        halo = (
            staged.halo
            if isinstance(staged, _StagedChunks)
            else staged[1]
        )
        if halo < plan.fetch_halo:
            raise ValueError(
                f"staged halo {halo} < required {plan.fetch_halo} "
                "(stage with the same window/method)"
            )
        if multi:
            if isinstance(staged, _StagedChunks):
                staged = staged.assemble_full()
            return _detect_staged_shared_multi(
                plan, staged, devices, progress
            )
        return plan.consume_shared(plan.shared_prob(staged), progress)
    if isinstance(staged, _StagedChunks):
        if staged.halo < plan.fetch_halo:
            raise ValueError(
                f"staged halo {staged.halo} < required {plan.fetch_halo} "
                "(stage_volume_chunked with the same window/method)"
            )
        if multi:
            # multi-device fan-out replicates the monolithic volume
            staged = staged.assemble_full()
        else:
            return _detect_staged_chunked(plan, staged, progress)
    big, fetch_halo = staged
    if fetch_halo < plan.fetch_halo:
        raise ValueError(
            f"staged halo {fetch_halo} < required {plan.fetch_halo} "
            "(stage_volume with the same window/method)"
        )
    off = fetch_halo - plan.fetch_halo  # staged halo may be generous
    # zero-extend so the highest ROI's window fits: the extension feeds
    # only grid-extension/out-of-volume prob voxels, all masked by
    # [vlo, vhi) before use — same exactness argument as host-path
    # prepare()'s grid extension
    pad_hi = [
        max(
            0,
            max(c[d] for _, c in plan.grid)
            + off + plan.pipe.padded_shape[d] - big.shape[d],
        )
        for d in range(3)
    ]
    if any(pad_hi):
        big = jnp.pad(big, [(0, p) for p in pad_hi])

    if multi:
        return _detect_staged_multi(plan, big, off, devices, progress)

    def outs():
        for key, corner in plan.grid:
            lo_want, vlo, vhi = plan.region(corner)
            origin = tuple(c + off for c in corner)
            yield (
                key, corner, plan.pipe.forward_from(big, origin),
                lo_want, vlo, vhi,
            )

    return plan.consume(outs(), progress)


def _detect_staged_chunked(plan, staged: "_StagedChunks", progress):
    """ROI sweep over chunk-staged volume: each ROI's padded window is
    assembled on device from the chunks it covers (device-to-device
    copies), then fed to the SAME compiled per-ROI forward with origin
    (0, 0, 0) — results are bitwise the monolithic staged sweep's
    (tests/test_large.py).  Because a window's assembly depends only on
    its own chunks, early ROI z-rows compute while later chunks are
    still crossing the wire — upload/compute overlap the monolithic
    form cannot have."""
    off = staged.halo - plan.fetch_halo
    P = plan.pipe.padded_shape

    def outs():
        for key, corner in plan.grid:
            lo_want, vlo, vhi = plan.region(corner)
            start = tuple(c + off for c in corner)
            window = staged.window(start, P)
            yield (
                key, corner, plan.pipe.forward_from(window, (0, 0, 0)),
                lo_want, vlo, vhi,
            )

    return plan.consume(outs(), progress)


def _detect_staged_shared_multi(plan, staged, devices, progress):
    """Fan the SHARED whole-volume forward over local devices by z-bands.

    The ROI grid's z-rows split into contiguous uniform bands, one per
    device; each device forwards its band's sub-volume (+-h halo) into a
    local -inf shell with the band pipeline (one compile serves every
    band), and each ROI's postprocess dispatches on the device owning
    its band.  Every prob voxel is computed with monolithic tile
    semantics (band grids anchor at band_z0 - h == 0 mod size_multiple),
    so detections are bit-identical to the single-device shared and roi
    modes (tests/test_large.py::test_staged_shared_forward_multi_device).
    """
    big, halo = staged
    rpb, nb, b0s = plan._band_partition(len(devices))
    if nb == 1:  # single z-row grid: nothing to fan out
        return plan.consume_shared(
            plan.shared_prob((big, halo)), progress
        )
    fp = plan.band_pipe(rpb)
    # zero-extend so the LAST band's forward windows stay in bounds
    # (extension feeds only out-of-volume probs, -inf'd by the masks)
    off = halo - plan.ctx
    tin = fp._tin
    _, py, px = fp.padded_shape
    z_top = max(zs for zs, _ in fp._slabs) + tin
    need = (off + b0s[-1] - plan.h + z_top, off + py, off + px)
    pad_hi = [max(0, n - s) for n, s in zip(need, big.shape)]
    if any(pad_hi):
        big = jnp.pad(big, [(0, p) for p in pad_hi])
    shells = []
    for i, b0 in enumerate(b0s):
        d = devices[i]
        big_i = jax.device_put(big, d)
        vars_i = jax.device_put(plan.pipe.variables, d)
        shells.append(
            plan.shared_prob_band(big_i, halo, b0, fp, vars_i, d)
        )
    return plan.consume_shared_multi(shells, rpb, progress)


def _detect_staged_multi(plan, big, off, devices, progress):
    """Fan :func:`detect_staged`'s ROI sweep over local devices.

    The staged volume and the params are replicated once per device
    (device-to-device copies on a real multi-chip host) and the disjoint
    ROI cores round-robin across them; each device runs the SAME
    compiled plan (jit caches one executable per device), and the
    host-side merge is identical to the single-device sweep — so
    detections are bit-identical, just produced ~len(devices) times
    faster.  The dispatch-ahead window scales by the device count so
    every chip keeps its own pipeline full (per-device in-flight buffer
    count — the HBM budget — is unchanged)."""
    import jax

    bigs = [jax.device_put(big, d) for d in devices]
    varss = [jax.device_put(plan.pipe.variables, d) for d in devices]
    n = len(devices)
    window_save = plan.pipeline_window
    plan.pipeline_window = max(window_save * n, n + 1)
    try:

        def outs():
            for i, (key, corner) in enumerate(plan.grid):
                lo_want, vlo, vhi = plan.region(corner)
                origin = tuple(c + off for c in corner)
                j = i % n
                yield (
                    key, corner,
                    plan.pipe.forward_from(
                        bigs[j], origin, variables=varss[j]
                    ),
                    lo_want, vlo, vhi,
                )

        return plan.consume(outs(), progress)
    finally:
        plan.pipeline_window = window_save


@functools.lru_cache(maxsize=8)
def _staging_pad(h: int):
    """Jitted 3-D reflect pad by ``h`` per face (device-side halo build).

    ``jnp.pad(mode="reflect")`` is pure index copies — bitwise identical
    to ``np.pad`` — so building the halo on device instead of uploading
    it saves the halo's wire bytes (~8% at 1k^3 with h=14) through the
    ~38 MB/s host link at zero semantic risk."""

    @jax.jit
    def pad(v):
        return jnp.pad(v, [(h, h)] * 3, mode="reflect")

    return pad


def warm_staging_pad(shape, dtype, halo: int):
    """Pre-compile :func:`stage_volume`'s device pad for ``shape`` without
    a wire transfer (the warm input is created on device), so a timed
    first upload isn't charged the one-off XLA compile."""
    _staging_pad(halo)(jnp.zeros(to3d(shape), dtype)).block_until_ready()


class _StagedChunks:
    """Disjoint raw z-chunks of a volume staged in HBM (see
    :func:`stage_volume_chunked`).  Each ROI window is assembled on
    device from the chunks it covers, so (a) only the volume's raw bytes
    cross the wire and (b) an ROI's forward can dispatch as soon as ITS
    chunks have arrived — the upload overlaps the sweep."""

    __slots__ = ("chunks", "halo", "bounds")

    # window-assembly executables keyed by the full static signature
    # (geometry + chunk shapes + dtype) — shared across instances so a
    # re-upload of the same volume shape compiles nothing
    _asm_cache: dict = {}

    def __init__(self, chunks, halo, bounds):
        self.chunks = chunks
        self.halo = halo
        self.bounds = bounds

    def window(self, start, size):
        """Device-assemble ``B[start : start + size]`` where ``B`` is the
        reflect-by-``halo`` padded volume extended with zeros on the high
        side — bitwise what :func:`stage_volume`'s monolithic ``big``
        (plus :func:`detect_staged`'s zero extension) holds there.

        Per axis: a front-reflect run (only windows at face 0), the raw
        span, a back-reflect run (<= halo), then zeros; y/x are plain
        slices of the full-xy chunks, z gathers only the covering chunks
        (so the assembly dispatch waits for THOSE transfers, not all)."""
        H = self.halo
        shape = (self.bounds[-1],) + tuple(self.chunks[0].shape[1:3])
        fr, ra, rb, br, zr = [], [], [], [], []
        for c, P, S in zip(start, size, shape):
            f = max(0, H - c)
            a = max(0, c - H)
            b = min(S, c + P - H)
            r = min(max(0, c + P - H - S), H)
            fr.append(f)
            ra.append(a)
            rb.append(b)
            br.append(r)
            zr.append(P - f - (b - a) - r)
        bounds = self.bounds
        i0 = next(i for i in range(len(bounds) - 1)
                  if bounds[i + 1] > ra[0])
        i1 = next(i for i in range(len(bounds) - 1)
                  if bounds[i + 1] >= rb[0]) + 1
        lo0 = ra[0] - bounds[i0]
        hi1 = rb[0] - bounds[i1 - 1]
        n_z = rb[0] - ra[0]
        key = (tuple(fr), tuple(ra), tuple(rb), tuple(br), tuple(zr),
               tuple(c.shape for c in self.chunks[i0:i1]),
               str(self.chunks[0].dtype), lo0, hi1)
        fn = self._asm_cache.get(key)
        if fn is None:
            pads_r = [(fr[d], br[d]) for d in range(3)]
            pads_z = [(0, zr[d]) for d in range(3)]

            @jax.jit
            def fn(*cs):
                if len(cs) == 1:
                    raw = cs[0][lo0 : lo0 + n_z]
                else:
                    parts = (
                        [cs[0][lo0:]] + list(cs[1:-1]) + [cs[-1][:hi1]]
                    )
                    raw = jnp.concatenate(parts, axis=0)
                raw = raw[:, ra[1] : rb[1], ra[2] : rb[2]]
                return jnp.pad(
                    jnp.pad(raw, pads_r, mode="reflect"), pads_z
                )

            self._asm_cache[key] = fn
        return fn(*self.chunks[i0:i1])

    def assemble_full(self):
        """Monolithic ``(big, halo)`` from the chunks (device concat +
        pad) — compatibility bridge for paths that need the whole padded
        volume (e.g. the multi-device fan-out)."""
        raw = (
            jnp.concatenate(self.chunks, axis=0)
            if len(self.chunks) > 1
            else self.chunks[0]
        )
        return _staging_pad(self.halo)(raw), self.halo


def stage_volume_chunked(volume: np.ndarray, plan=None,
                         halo: int | None = None, chunk: int = 128):
    """Upload a volume as disjoint raw z-chunks for :func:`detect_staged`.

    Wire-minimal AND overlap-friendly: only the raw bytes are
    transferred (the reflect halo is built per ROI window on device,
    bitwise :func:`stage_volume`'s), and since an ROI window depends
    only on the chunks it covers, early ROI rows start computing while
    later chunks are still uploading — the staging transfer rides under
    the sweep instead of strictly preceding it.  Falls back to
    :func:`stage_volume`'s monolithic form when the volume is too small
    to reflect on device."""
    if plan is None and halo is None:
        raise ValueError(
            "stage_volume_chunked needs a plan (from make_stream_plan) "
            "or an explicit halo to size the reflect border"
        )
    h = plan.fetch_halo if halo is None else halo
    vol = np.asarray(volume)
    if vol.dtype not in (np.uint8, np.float32):
        vol = vol.astype(np.float32)
    if min(vol.shape) <= h:
        return stage_volume(vol, halo=h)
    vz = vol.shape[0]
    bounds = list(range(0, vz, max(1, chunk))) + [vz]
    if bounds[-2] == vz:
        bounds.pop(-2)
    chunks = [
        jax.device_put(np.ascontiguousarray(vol[b0:b1]))
        for b0, b1 in zip(bounds, bounds[1:])
    ]
    return _StagedChunks(chunks, h, bounds)


def stage_volume(volume: np.ndarray, plan=None, halo: int | None = None):
    """Upload a whole volume to HBM with its streaming reflect halo.

    Returns ``(big, halo)`` for :func:`detect_staged`'s ``staged=`` — the
    one wire transfer, reusable across detection calls.  ``halo`` must be
    >= the plan's ``fetch_halo`` (``context + window//2 + context``).

    Only the RAW volume crosses the wire; the reflect halo is built on
    device (:func:`_staging_pad` — bitwise identical to the previous
    host-side ``np.pad``).  Volumes too small to reflect (any extent
    <= ``halo``) fall back to host-side padding."""
    if plan is None and halo is None:
        raise ValueError(
            "stage_volume needs a plan (from make_stream_plan) or an "
            "explicit halo to size the staged reflect border"
        )
    h = plan.fetch_halo if halo is None else halo
    vol = np.asarray(volume)
    if vol.dtype not in (np.uint8, np.float32):
        vol = vol.astype(np.float32)
    if min(vol.shape) > h:
        return _staging_pad(h)(jax.device_put(vol)), h
    pad = [(h, h)] * 3
    return jax.device_put(np.pad(vol, pad, mode="reflect")), h


def detect_h5(
    spec: ModelSpec,
    variables,
    path: str,
    dataset: str | None = None,
    **kw,
) -> Tbars:
    """Streaming detection straight from an HDF5 file."""
    shape, read = h5_reader(path, dataset)
    return detect_streaming(spec, variables, shape, read, **kw)
