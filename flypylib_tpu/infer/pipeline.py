"""Fused detect pipeline: tiled forward + NMS + CC with minimal host I/O.

North star [B:5]: "rewrite the postprocessing as on-device XLA ops so
probability maps never leave device memory".  This engine is built for
latency/bandwidth-bound hosts:

- ONE upload of the (padded) volume — uint8 supported, 4x cheaper on the
  wire than f32 — optionally split into z-slabs whose transfers overlap
  the previous slab's forward compute (all dispatches are async; the
  upload and the convolutions pipeline against each other);
- the tile sweep, sigmoid, NMS candidate extraction, and
  connected-components labeling/centroid reduction run in TWO dispatches
  (forward-per-slab + one postprocess), with only the tiny detection
  arrays transferred back;
- the operating threshold is traced (sweeps don't recompile) and can be
  computed in-graph as a plane-subsampled quantile of the probability map.

Semantics are identical to TiledInference + nms_device + components_device
— pinned by tests/test_pipeline.py against the scipy host reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from flypylib_tpu.io.synapses import Tbars
from flypylib_tpu.models.zoo import ModelSpec
from flypylib_tpu.ops.host_reference import sort_detections
from flypylib_tpu.ops.nms import candidate_mask
from flypylib_tpu.utils import ceil_div, to3d


class _StagedRaw:
    """Disjoint raw z-chunks staged in HBM (see :meth:`DetectPipeline.stage`).

    The reflect halo, inter-slab overlap, and grid extension are built on
    device per slab, so only the volume's own bytes cross the wire."""

    __slots__ = ("chunks",)

    def __init__(self, chunks):
        self.chunks = chunks


def _zoff(zs: int) -> jax.Array:
    """(zs, 0, 0) write-offset vector for the plain (non-shell) output."""
    return jnp.asarray((zs, 0, 0), jnp.int32)


def _extract_candidates(prob, mask, max_detections):
    """First-k candidates in flat-index order via cumsum compaction —
    ~2.5x cheaper than a full-volume lax.top_k at 256^3 (the caller
    grows-and-retries on saturation, so completeness doesn't depend on
    confidence ordering; the host sorts the tiny result canonically)."""
    from flypylib_tpu.ops.components import compact_true_indices

    n = prob.size
    idx = compact_true_indices(mask.reshape(-1), max_detections)
    valid = idx < n
    safe = jnp.minimum(idx, n - 1)
    conf = jnp.where(valid, prob.reshape(-1)[safe], -jnp.inf)
    shape = prob.shape
    z = safe // (shape[1] * shape[2])
    rem = safe % (shape[1] * shape[2])
    locs = jnp.stack([z, rem // shape[2], rem % shape[2]], axis=1)
    return locs.astype(jnp.int32), conf, valid


class DetectPipeline:
    """Two-dispatch volume -> detections engine for a fixed volume shape.

    If ``threshold_quantile`` is set, the operating threshold is computed
    in-graph as that quantile of the probability map (handy for
    benchmarks/untrained nets); otherwise ``threshold`` is used.
    """

    def __init__(
        self,
        spec: ModelSpec,
        variables,
        vol_shape,
        tile_out: int = 128,
        tile_batch: int = 1,
        window=5,
        threshold: float = 0.5,
        threshold_quantile: float | None = None,
        max_detections: int = 4096,
        max_components: int = 4096,
        input_scale: float | None = None,
        pad_mode: str = "reflect",
        run_cc: bool = True,
        pre_padded: bool = False,
        two_phase: bool | None = None,
        split_write: bool = False,
    ):
        from flypylib_tpu.infer.tiled import TiledInference
        from flypylib_tpu.ops.components import components_device

        self.spec = spec
        self.variables = variables
        self.vol_shape = to3d(vol_shape)
        self.window = to3d(window)
        self.threshold = float(threshold)
        n_vox = int(np.prod(self.vol_shape))
        self._n_vox = n_vox
        max_detections = min(max_detections, n_vox)  # top_k k <= volume
        self.max_detections = max_detections
        self.max_components = max_components
        self.threshold_quantile = threshold_quantile
        self.input_scale = input_scale
        self.pad_mode = pad_mode
        self.run_cc = run_cc
        self.pre_padded = pre_padded

        # reuse the tile-grid planner from TiledInference
        self._tiled = TiledInference(
            spec, variables, tile_out=tile_out, tile_batch=tile_batch
        )
        tin = self._tiled.tile_in
        corners, out_shape = self._tiled.plan(self.vol_shape)
        self._out_shape = out_shape
        vz, vy, vx = self.vol_shape

        # group tile corners by z-start: each group is one upload slab of
        # tin z-planes whose transfer overlaps the previous slab's compute
        z_starts = sorted({c[0] for c in corners})
        self._slabs = []
        B = tile_batch
        for zs in z_starts:
            cs = [c for c in corners if c[0] == zs]
            nb = ceil_div(len(cs), B)
            cs = cs + [cs[-1]] * (nb * B - len(cs))
            local = np.asarray(
                [(0, c[1], c[2]) for c in cs], np.int32
            ).reshape(nb, B, 3)
            self._slabs.append((zs, jnp.asarray(local)))
        self._tin = tin

        # regular-grid scatter: when every tile batch covers whole rows of
        # the per-slab (y, x) corner grid with non-overlapping outputs,
        # the batch assembles into one contiguous block by transpose and
        # lands with ONE dynamic_update_slice instead of a B-step scan
        # of small updates
        n_x = len({c[2] for c in corners})
        n_yx = len({(c[1], c[2]) for c in corners})
        tout = self._tiled.tile_out
        if (
            self._tiled.stride == tout
            and n_yx % B == 0
            and B % n_x == 0
        ):
            self._scatter_grid = (B // n_x, n_x)
        else:
            self._scatter_grid = None

        def write_tiles(out, probs, corner_batch, off):
            """Stitch one tile batch into the output map at write offset
            ``off`` (a traced (3,) vector: the slab's z start, plus the
            shell origin when writing straight into a shared -inf shell
            — see :meth:`forward_slabs`)."""
            if self._scatter_grid is not None:
                rows, cols = self._scatter_grid
                blk = probs.reshape(rows, cols, tout, tout, tout)
                blk = blk.transpose(2, 0, 3, 1, 4).reshape(
                    tout, rows * tout, cols * tout
                )
                c0 = corner_batch[0]
                return lax.dynamic_update_slice(
                    out, blk, (c0[0] + off[0], c0[1] + off[1],
                               c0[2] + off[2])
                )

            def write(out, args):
                tile, c = args
                return (
                    lax.dynamic_update_slice(
                        out, tile, (c[0] + off[0], c[1] + off[1],
                                    c[2] + off[2])
                    ),
                    None,
                )

            out, _ = lax.scan(write, out, (probs, corner_batch))
            return out

        self._write_tiles = write_tiles

        @functools.partial(jax.jit, donate_argnums=(3,))
        def fwd_slab(variables, slab, corners_local, out, w_off):
            # w_off is traced (dynamic_update_slice takes traced starts):
            # every slab shares ONE compiled executable
            scale = input_scale
            if slab.dtype == jnp.uint8:
                scale = (1.0 / 255.0) if scale is None else scale

            def body(out, corner_batch):
                tiles = jax.vmap(
                    lambda c: lax.dynamic_slice(
                        slab, (c[0], c[1], c[2]), (tin, tin, tin)
                    )
                )(corner_batch)
                x = tiles.astype(jnp.float32)
                if scale is not None:
                    x = x * scale
                logits = spec.module.apply(variables, x[..., None],
                                           train=False)
                probs = jax.nn.sigmoid(logits[..., 0])
                return write_tiles(out, probs, corner_batch, w_off), None

            out, _ = lax.scan(body, out, corners_local)
            return out

        def make_post(k_det: int, k_comp: int):
            @jax.jit
            def post(out, valid_lo, valid_hi, threshold):
                from flypylib_tpu.ops.nms import mask_valid_region

                prob = out[:vz, :vy, :vx]
                # monolithic -inf boundary semantics for ROI runs whose
                # prob region extends past the true volume
                prob, inb = mask_valid_region(prob, valid_lo, valid_hi)
                n_inb = jnp.sum(inb, dtype=jnp.int32)
                if threshold_quantile is not None:
                    # plane-subsampled quantile (~1M elements): a
                    # full-volume sort costs more than the rest of the
                    # postprocessing, and the operating point only needs to
                    # be statistically right.  Whole z-planes keep the
                    # access contiguous (flat striding is a gather).
                    # The quantile is taken over IN-BOUNDS voxels only:
                    # after an ascending sort the -inf out-of-bounds voxels
                    # occupy the low slots, so the in-bounds subset is the
                    # top n_inb slots (linear interpolation, matching
                    # jnp.quantile on that subset).
                    stride = max(1, prob.size // (1 << 20))
                    sub = jnp.sort(prob[::stride].reshape(-1))
                    n_sub = sub.shape[0]
                    n_in = jnp.maximum(
                        jnp.sum(inb[::stride], dtype=jnp.int32), 1
                    )
                    pos = threshold_quantile * (n_in - 1).astype(jnp.float32)
                    lo = jnp.floor(pos).astype(jnp.int32)
                    frac = pos - lo.astype(jnp.float32)
                    base = n_sub - n_in
                    v0 = sub[jnp.minimum(base + lo, n_sub - 1)]
                    v1 = sub[jnp.minimum(base + lo + 1, n_sub - 1)]
                    thr = v0 * (1.0 - frac) + v1 * frac
                else:
                    thr = threshold  # traced: sweeps don't recompile
                mask = candidate_mask(prob, self.window, thr)
                nms_out = _extract_candidates(prob, mask, k_det)
                if run_cc:
                    cc_out = components_device(
                        prob, threshold=thr, max_components=k_comp
                    )
                else:
                    cc_out = None
                return nms_out, cc_out, n_inb

            return post

        self._fwd_slab = fwd_slab
        self._make_post = make_post
        self._posts: dict = {}

        # split-write slab forward: each tile's probs materialize in
        # their OWN executable (a plain (tout)^3 output, like the
        # per-ROI covering forward's) and a second tiny (donated)
        # executable lands them in the output buffer.  Needed by the
        # shared-forward streaming mode for packed pooling models:
        # fusing (or even scan-stacking) the packed->spatial unpack with
        # a multi-tile buffer let the first platform's layout
        # assignment materialize the parity tensor padded 64x — a
        # multi-GB temp (compiled memory analysis: the scan-stacked form
        # carried it; the per-ROI-style single-tile forward did not).
        # Across the dispatch boundary both sides keep default layouts;
        # dispatches are async, so the per-tile pairs cost no host
        # blocking.
        self._split_write = bool(split_write)
        if split_write:

            @jax.jit
            def fwd_tile(variables, slab, corner):
                scale = input_scale
                if slab.dtype == jnp.uint8:
                    scale = (1.0 / 255.0) if scale is None else scale
                tile = lax.dynamic_slice(
                    slab, (corner[0], corner[1], corner[2]),
                    (tin, tin, tin),
                )
                x = tile.astype(jnp.float32)
                if scale is not None:
                    x = x * scale
                logits = spec.module.apply(
                    variables, x[None, ..., None], train=False
                )
                return jax.nn.sigmoid(logits[0, ..., 0])

            @functools.partial(jax.jit, donate_argnums=(0,))
            def write_tile(out, probs, corner, w_off):
                return lax.dynamic_update_slice(
                    out, probs,
                    (corner[0] + w_off[0], corner[1] + w_off[1],
                     corner[2] + w_off[2]),
                )

            self._fwd_tile = fwd_tile
            self._write_tile = write_tile

        # raw-chunk staging plan (wire-minimal stage()): upload the
        # UNPADDED volume as disjoint z-chunks and build each slab's
        # reflect halo / overlap / grid extension on device.  At 256^3
        # t64b16 the padded-slab upload moves ~23% more bytes than the
        # volume itself (xy halo + 12-plane inter-slab overlap) through
        # a ~38 MB/s link; the assembled slabs are bitwise identical to
        # prepare()'s (jnp.pad reflect == np.pad reflect — index
        # copies), pinned by tests/test_pipeline.py.  Chunk k feeds
        # slabs k-1 and k only, so uploads still overlap compute.
        self._raw_plan = None
        c = self._tiled.ctx
        z_starts = [zs for zs, _ in self._slabs]
        eligible = (
            not pre_padded
            and pad_mode == "reflect"
            and min(self.vol_shape) > c
            and (len(z_starts) == 1 or z_starts[1] > c)
            and all(
                z_starts[k] + tin <= z_starts[k + 2]
                for k in range(len(z_starts) - 2)
            )
            and (len(z_starts) == 1 or z_starts[-1] - c < vz)
        )
        if eligible:
            bounds = [0] + [zs - c for zs in z_starts[1:]] + [vz]
            slabs_meta = []
            for k, zs in enumerate(z_starts):
                ra = bounds[k]
                rb = min(vz, zs + tin - c)
                fr = c - zs if zs < c else 0
                br = min(max(0, zs + tin - c - vz), c)
                zr = tin - fr - (rb - ra) - br
                take = max(0, rb - bounds[k + 1]) if k + 1 < len(
                    bounds
                ) - 1 else 0
                if zr < 0 or (take and take > bounds[k + 2] - bounds[k + 1]):
                    slabs_meta = None
                    break
                slabs_meta.append((take, fr, br, zr))
            if slabs_meta is not None:
                ey = self._out_shape[1] - vy
                ex = self._out_shape[2] - vx

                @functools.partial(
                    jax.jit, static_argnames=("take", "fr", "br", "zr")
                )
                def assemble(a, b, take, fr, br, zr):
                    raw = (
                        jnp.concatenate([a, b[:take]], axis=0)
                        if take
                        else a
                    )
                    s = jnp.pad(
                        raw, [(fr, br), (c, c), (c, c)], mode="reflect"
                    )
                    return jnp.pad(s, [(0, zr), (0, ey), (0, ex)])

                self._raw_plan = {
                    "bounds": bounds,
                    "slabs": slabs_meta,
                    "assemble": assemble,
                }

        # two-phase slab forward: phase A (pack + stage-A convs + parity
        # split) and phase B (stage-B convs + head + logits + stitch) as
        # SEPARATE dispatches.  Inside one executable XLA schedules the
        # first stage-B conv ~5x slower after the split even with a
        # barrier; across a dispatch boundary it runs at full speed
        # (chain_fix3 study) — ~1.9x on the conv chain.  Dispatches are
        # async, so the extra boundary costs no host blocking.
        mod = spec.module
        if two_phase is None:
            two_phase = (
                hasattr(mod, "apply_stage_a")
                and hasattr(mod, "apply_stage_b")
                and getattr(mod, "stage_b", None) == "split"
                and getattr(mod, "n_lead", 0) > 0
            )
        self.two_phase = bool(two_phase)
        if self.two_phase:
            _, py_, px_ = self.padded_shape

            @jax.jit
            def slab_phase_a(variables, big, origin, zs, local):
                scale = input_scale
                if big.dtype == jnp.uint8:
                    scale = (1.0 / 255.0) if scale is None else scale
                slab = lax.dynamic_slice(
                    big, (origin[0] + zs, origin[1], origin[2]),
                    (tin, py_, px_),
                )

                def body(_, corner_batch):
                    tiles = jax.vmap(
                        lambda c: lax.dynamic_slice(
                            slab, (c[0], c[1], c[2]), (tin, tin, tin)
                        )
                    )(corner_batch)
                    x = tiles.astype(jnp.float32)
                    if scale is not None:
                        x = x * scale
                    return None, spec.module.apply_stage_a(
                        variables, x[..., None]
                    )

                _, xa = lax.scan(body, None, local)
                return xa  # (nb, 8B, d, h, w, c)

            @functools.partial(jax.jit, donate_argnums=(2,))
            def slab_phase_b(variables, xa, out, local, w_off):
                def body(out, args):
                    xab, corner_batch = args
                    logits = spec.module.apply_stage_b(variables, xab)
                    probs = jax.nn.sigmoid(logits[..., 0])
                    return write_tiles(out, probs, corner_batch, w_off), None

                out, _ = lax.scan(body, out, (xa, local))
                return out

            self._slab_phase_a = slab_phase_a
            self._slab_phase_b = slab_phase_b
            # cap per-dispatch stage-A activations: a phase-A call holds
            # its whole batch-scan's xa in HBM (nb x 8B x d^3 x c), which
            # scales with the slab's xy footprint — at a 1k^3 shared
            # forward one 16-batch slab's xa is ~5 GB.  Chunk the batch
            # scan so each phase-A/B round holds <= ~1.5 GB of xa
            # (duplicated tail batches rewrite identical tiles — the
            # established bitwise-safe padding trick).
            xa_sd = jax.eval_shape(
                lambda v, x: mod.apply_stage_a(v, x),
                variables,
                jax.ShapeDtypeStruct(
                    (tile_batch, tin, tin, tin, 1), jnp.float32
                ),
            )
            per_batch = sum(
                int(np.prod(l.shape)) * l.dtype.itemsize
                for l in jax.tree.leaves(xa_sd)
            )
            self._pa_chunk = max(1, (3 << 29) // max(per_batch, 1))

        # single-dispatch forward over a device-resident global volume:
        # every slab slice + tile sweep + stitch runs in ONE executable
        # with a TRACED origin, so one compile serves every ROI of a
        # streaming sweep and the host never blocks between slabs
        # (per-slab eager dispatches cost a host roundtrip each).
        nb0 = self._slabs[0][1].shape[0]
        if all(local.shape[0] == nb0 for _, local in self._slabs):
            zs_arr = jnp.asarray([zs for zs, _ in self._slabs], jnp.int32)
            locals_arr = jnp.stack([local for _, local in self._slabs])

            @jax.jit
            def fwd_from_fused(variables, big, origin):
                scale = input_scale
                if big.dtype == jnp.uint8:
                    scale = (1.0 / 255.0) if scale is None else scale
                _, py, px = self.padded_shape
                out0 = jnp.zeros(self._out_shape, dtype=jnp.float32)

                def slab_body(out, args):
                    zs, local = args
                    slab = lax.dynamic_slice(
                        big, (origin[0] + zs, origin[1], origin[2]),
                        (tin, py, px),
                    )

                    def body(out, corner_batch):
                        tiles = jax.vmap(
                            lambda c: lax.dynamic_slice(
                                slab, (c[0], c[1], c[2]), (tin, tin, tin)
                            )
                        )(corner_batch)
                        x = tiles.astype(jnp.float32)
                        if scale is not None:
                            x = x * scale
                        logits = spec.module.apply(
                            variables, x[..., None], train=False
                        )
                        probs = jax.nn.sigmoid(logits[..., 0])
                        w_off = jnp.stack(
                            [zs, jnp.int32(0), jnp.int32(0)]
                        )
                        return write_tiles(out, probs, corner_batch,
                                           w_off), None

                    out, _ = lax.scan(body, out, local)
                    return out, None

                out, _ = lax.scan(slab_body, out0, (zs_arr, locals_arr))
                return out

            self._fwd_from_fused = fwd_from_fused
        else:  # ragged slab grids fall back to the per-slab path
            self._fwd_from_fused = None

    def _phase_a_chunks(self, local):
        """Split one slab's (nb, B, 3) corner scan into chunks bounded by
        the stage-A activation budget (see ``_pa_chunk`` in __init__);
        ragged tails repeat the last batch (duplicate writes are bitwise
        identical — the corner-padding trick)."""
        nb = local.shape[0]
        ch = self._pa_chunk
        if ch >= nb:
            return [local]
        chunks = []
        for i in range(0, nb, ch):
            part = local[i : i + ch]
            if part.shape[0] < ch:
                pad = jnp.broadcast_to(
                    part[-1:], (ch - part.shape[0],) + part.shape[1:]
                )
                part = jnp.concatenate([part, pad], axis=0)
            chunks.append(part)
        return chunks

    def _forward_two_phase(self, big, origin, variables):
        """Per-slab phase-A/phase-B dispatch loop over a device-resident
        volume (all dispatches async; ``xa`` and ``out`` are donated so
        peak HBM is one chunk's stage-A activations + the output map)."""
        origin = jnp.asarray(origin, jnp.int32)
        out = jnp.zeros(self._out_shape, dtype=jnp.float32)
        for zs, local in self._slabs:
            for lc in self._phase_a_chunks(local):
                xa = self._slab_phase_a(
                    variables, big, origin, jnp.int32(zs), lc
                )
                out = self._slab_phase_b(
                    variables, xa, out, lc, _zoff(zs)
                )
        return out

    def forward_slabs(self, slab_for, variables=None, out=None,
                      offset=(0, 0, 0), tile_for=None) -> jax.Array:
        """Drive the per-slab forward over externally provided padded
        slab windows — ``slab_for(zs)`` returns the ``(tin, py, px)``
        window whose planes start at padded-volume z ``zs`` (e.g.
        device-assembled from chunk-staged uploads).  Used by the
        shared-forward streaming mode (infer/large).  Bitwise the
        :meth:`forward_from` result on the same data: identical
        executables, identical write order.

        ``out``/``offset`` redirect the tile writes into a caller-owned
        (donated) buffer at ``offset`` — the shared mode passes its
        -inf shell directly, so the full prob map and the shell never
        coexist in HBM (writes land at identical values; only the
        destination buffer changes).

        ``tile_for(zs, c)`` (split-write mode only) fetches one
        ``(tin, tin, tin)`` tile window directly instead of a whole
        xy-footprint slab — a 58 MB window instead of a 433 MB one at
        1k^3 U-Net shapes, part of the split-write peak-HBM budget."""
        v = self.variables if variables is None else variables
        if out is None:
            out = jnp.zeros(self._out_shape, dtype=jnp.float32)
        off = np.asarray(offset, np.int64)
        if self.two_phase:
            origin0 = jnp.zeros((3,), jnp.int32)
            for zs, local in self._slabs:
                window = slab_for(zs)
                for lc in self._phase_a_chunks(local):
                    xa = self._slab_phase_a(
                        v, window, origin0, jnp.int32(0), lc
                    )
                    out = self._slab_phase_b(
                        v, xa, out, lc,
                        jnp.asarray(off + (zs, 0, 0), jnp.int32),
                    )
            return out
        if self._split_write:
            # throttle dispatch-ahead: buffers are ALLOCATED at dispatch
            # time, so an unthrottled host loop would hold every tile's
            # probs (27 x 161 MB at tin 388) at once.  Bound the backlog
            # WITHOUT draining: block on a tiny token slice from the
            # tile ``backlog`` dispatches ago — in-order execution means
            # that tile (and everything before it) has completed and
            # freed its buffers, while the newer dispatches already sit
            # in the device queue.  The previous form (a forced read of
            # the LATEST write) was a full pipeline drain + a host
            # roundtrip per tile.
            from collections import deque

            tout = self._tiled.tile_out
            # ~0.5 GB of in-flight probs (+ input windows and temps)
            backlog = max(1, (1 << 29) // (6 * tout**3))
            tokens: deque = deque()
            zero3 = jnp.zeros((3,), jnp.int32)
            for zs, local in self._slabs:
                window = None if tile_for is not None else slab_for(zs)
                w_off = off + (zs, 0, 0)
                seen = set()
                for c in np.asarray(local).reshape(-1, 3):
                    key = tuple(int(v_) for v_ in c)
                    if key in seen:  # batch-padding duplicates
                        continue
                    seen.add(key)
                    if tile_for is not None:
                        probs = self._fwd_tile(v, tile_for(zs, c), zero3)
                    else:
                        probs = self._fwd_tile(
                            v, window, jnp.asarray(c, jnp.int32)
                        )
                    out = self._write_tile(
                        out, probs,
                        jnp.asarray(c + w_off, jnp.int32), zero3,
                    )
                    tokens.append(out[:1, :1, 0])
                    if len(tokens) > backlog:
                        jax.device_get(tokens.popleft())
            return out
        for zs, local in self._slabs:
            out = self._fwd_slab(
                v, slab_for(zs), local, out,
                jnp.asarray(off + (zs, 0, 0), jnp.int32),
            )
        return out

    def prepare(self, volume: np.ndarray) -> np.ndarray:
        """Host-side pad (reflect halo + grid extension).  uint8 stays
        uint8 on the wire.

        With ``pre_padded=True`` the caller already supplied the
        ``context`` halo (shape = vol_shape + 2*context) — e.g. true
        neighbor data around an out-of-core ROI — and only the grid
        extension is added.
        """
        vol = np.asarray(volume)
        if vol.dtype not in (np.uint8, np.float32):
            vol = vol.astype(np.float32)
        c = self._tiled.ctx
        if self.pre_padded:
            expect = tuple(s + 2 * c for s in self.vol_shape)
            if vol.shape != expect:
                raise ValueError(
                    f"pre_padded volume must have shape {expect}, got "
                    f"{vol.shape}"
                )
            padded = vol
        else:
            if vol.shape != self.vol_shape:
                raise ValueError(
                    f"volume must have shape {self.vol_shape}, got {vol.shape}"
                )
            padded = np.pad(vol, c, mode=self.pad_mode) if c else vol
        extra = [(0, os - s) for s, os in zip(self.vol_shape, self._out_shape)]
        return np.pad(padded, extra)

    def _post_for(self, k_det: int, k_comp: int):
        key = (k_det, k_comp)
        if key not in self._posts:
            self._posts[key] = self._make_post(k_det, k_comp)
        return self._posts[key]

    def stage(self, volume: np.ndarray):
        """Upload the volume to HBM for :meth:`forward_staged` (queued
        back-to-back on the wire, so transfers overlap the previous
        slab's compute).  The return value can be passed to
        :meth:`forward_staged` any number of times — the device-resident
        operating mode (chip-bound throughput, wire excluded).

        On the default path only the volume's RAW bytes cross the wire
        as disjoint z-chunks; each slab's reflect halo, inter-slab
        overlap, and grid extension are assembled on device (bitwise
        identical to :meth:`prepare` — see ``_raw_plan`` in
        ``__init__``).  Pipelines the plan can't cover (``pre_padded``,
        non-reflect ``pad_mode``, volumes smaller than the context) fall
        back to host-padded slab uploads."""
        if self._raw_plan is not None:
            vol = np.asarray(volume)
            if vol.dtype not in (np.uint8, np.float32):
                vol = vol.astype(np.float32)
            if vol.shape != self.vol_shape:
                raise ValueError(
                    f"volume must have shape {self.vol_shape}, got "
                    f"{vol.shape}"
                )
            b = self._raw_plan["bounds"]
            return _StagedRaw([
                jax.device_put(np.ascontiguousarray(vol[b[i] : b[i + 1]]))
                for i in range(len(b) - 1)
            ])
        padded = self.prepare(volume)
        tin = self._tin
        return [
            jax.device_put(padded[zs : zs + tin]) for zs, _ in self._slabs
        ]

    def _staged_slabs(self, staged):
        """Yield the (tin, py, px) padded slab windows of a :meth:`stage`
        result — device-assembled for raw-chunk staging, as-is for the
        legacy padded-slab list."""
        if isinstance(staged, _StagedRaw):
            asm = self._raw_plan["assemble"]
            chunks = staged.chunks
            for k, (take, fr, br, zr) in enumerate(
                self._raw_plan["slabs"]
            ):
                # dummy second operand when the slab fits one chunk (the
                # static take=0 branch never reads it; passing chunks[k]
                # keeps the jit cache keyed on one extra shape at most)
                b = chunks[k + 1] if take else chunks[k]
                yield asm(chunks[k], b, take=take, fr=fr, br=br, zr=zr)
        else:
            yield from staged

    @property
    def padded_shape(self) -> tuple:
        """Shape of the padded input :meth:`prepare` produces (the region
        :meth:`forward_from` slices per ROI)."""
        c = self._tiled.ctx
        return tuple(os + 2 * c for os in self._out_shape)

    def forward_from(self, big: jax.Array, origin,
                     variables=None) -> jax.Array:
        """Forward over a window of a device-resident global volume.

        ``big`` is the whole (halo-padded, grid-extended) volume already
        staged in HBM; ``origin`` is the window's start index in ``big``
        such that ``big[origin : origin + padded_shape]`` equals what
        :meth:`prepare` would have produced for this ROI.  Slab slices are
        device-to-device (HBM bandwidth) — no host wire in the loop; the
        ROI forward is ONE dispatch on the fused path, or 2 async
        dispatches per slab on the (default, faster) two-phase packed
        path — origin/zs are traced either way, so one compile serves
        every ROI of a streaming sweep.

        ``variables`` overrides ``self.variables`` — pass a copy
        committed to ``big``'s device when fanning one plan's ROI sweep
        over several local chips (jit then compiles/executes on that
        device with no cross-device transfers in the steady state)."""
        v = self.variables if variables is None else variables
        if self.two_phase:
            return self._forward_two_phase(big, origin, v)
        if self._fwd_from_fused is not None:
            return self._fwd_from_fused(
                v, big, jnp.asarray(origin, jnp.int32)
            )
        oz, oy, ox = (int(v_) for v_ in origin)
        tin = self._tin
        _, py, px = self.padded_shape
        out = jnp.zeros(self._out_shape, dtype=jnp.float32)
        for zs, local in self._slabs:
            slab = lax.dynamic_slice(big, (oz + zs, oy, ox), (tin, py, px))
            out = self._fwd_slab(
                v, slab, local, out, _zoff(zs)
            )
        return out

    def forward_staged(self, staged) -> jax.Array:
        """Staged volume (from :meth:`stage`) -> device-resident prob
        map."""
        out = jnp.zeros(self._out_shape, dtype=jnp.float32)
        if self.two_phase:
            v = self.variables
            origin0 = jnp.zeros((3,), jnp.int32)
            for (zs, local), slab in zip(
                self._slabs, self._staged_slabs(staged)
            ):
                # each staged slab IS its own (tin, py, px) window
                for lc in self._phase_a_chunks(local):
                    xa = self._slab_phase_a(
                        v, slab, origin0, jnp.int32(0), lc
                    )
                    out = self._slab_phase_b(
                        v, xa, out, lc, _zoff(zs)
                    )
            return out
        for (zs, local), slab in zip(
            self._slabs, self._staged_slabs(staged)
        ):
            out = self._fwd_slab(
                self.variables, slab, local, out, _zoff(zs)
            )
        return out

    def stage_full(self, volume: np.ndarray) -> jax.Array:
        """Host-pad and upload the whole volume in one transfer — for the
        device-resident operating mode, where repeated :meth:`forward_full`
        calls run the fused single-dispatch forward (no per-slab
        dispatches; use :meth:`stage`/:meth:`forward_staged` instead when
        the upload itself should overlap compute)."""
        return jax.device_put(self.prepare(volume))

    def forward_full(self, big: jax.Array) -> jax.Array:
        """Fused whole-volume forward over :meth:`stage_full`'s upload."""
        return self.forward_from(big, (0, 0, 0))

    def forward(self, volume: np.ndarray) -> jax.Array:
        """volume -> device-resident prob map of shape ``_out_shape``
        (valid region is ``[:vz, :vy, :vx]``); uploads overlap compute."""
        return self.forward_staged(self.stage(volume))

    def postprocess_start(self, out: jax.Array, valid_lo=None,
                          valid_hi=None, k_det=None, k_comp=None):
        """Dispatch the postprocess for a prob map WITHOUT blocking.

        Returns an opaque handle for :meth:`postprocess_finish`; the
        device arrays start copying to the host asynchronously, so a
        streaming caller can dispatch the next ROI's forward before this
        ROI's results cross the wire (no per-ROI blocking roundtrip)."""
        lo = jnp.asarray(
            valid_lo if valid_lo is not None else (0, 0, 0), jnp.int32
        )
        hi = jnp.asarray(
            valid_hi if valid_hi is not None else self.vol_shape, jnp.int32
        )
        kd = self.max_detections if k_det is None else k_det
        kc = self.max_components if k_comp is None else k_comp
        res = self._post_for(kd, kc)(
            out, lo, hi, jnp.float32(self.threshold)
        )
        for leaf in jax.tree.leaves(res):
            leaf.copy_to_host_async()
        return (kd, kc, lo, hi, res)

    def postprocess_finish(self, started, out_provider=None):
        """Collect a :meth:`postprocess_start` handle into detection
        lists.  On top-k/CC saturation the postprocess MUST rerun with
        more capacity over the same prob map — ``out_provider`` (a
        zero-arg callable recomputing/returning the map) supplies it when
        the caller dropped the reference; with ``None`` the saturation is
        an error."""
        kd, kc, lo, hi, res = started
        while True:
            # ONE bulk device->host transfer: each np.asarray is its own
            # roundtrip, and there are ~8 result arrays
            (locs, conf, valid), cc, n_inb = jax.device_get(res)
            n = int(valid.sum())
            n_inb = int(n_inb)
            # saturation: every slot valid and more in-bounds voxels exist
            # that could have been candidates
            grow_det = n == kd and kd < n_inb
            grow_cc = cc is not None and bool(cc[3].any())
            if not (grow_det or grow_cc):
                break
            if out_provider is None:
                raise RuntimeError(
                    "postprocess saturated and the prob map is gone; "
                    "pass out_provider to enable grow-and-retry"
                )
            if grow_det:
                kd = min(kd * 4, n_inb)
            if grow_cc:
                kc *= 4
            res = self._post_for(kd, kc)(
                out_provider(), lo, hi, jnp.float32(self.threshold)
            )
        # candidates arrive in flat-index order; canonicalize (conf desc,
        # z/y/x asc) on host — the list is tiny
        nms_det = sort_detections(
            locs[:n].astype(np.float64), conf[:n]
        )
        cc_det = None
        if cc is not None:
            cents, cconf, cvalid, _ = cc
            cc_det = sort_detections(cents[cvalid], cconf[cvalid])
        return nms_det, cc_det

    def postprocess(self, out: jax.Array, valid_lo=None, valid_hi=None):
        """Device prob map (from :meth:`forward`) -> detection lists."""
        return self.postprocess_finish(
            self.postprocess_start(out, valid_lo, valid_hi),
            out_provider=lambda: out,
        )

    def __call__(self, volume: np.ndarray, valid_lo=None, valid_hi=None):
        """volume -> (nms Tbars, cc Tbars | None).

        ``valid_lo``/``valid_hi`` optionally bound the region (in
        prob-volume coords) whose voxels are real — outside it the map is
        treated as -inf (see post).

        On NMS top-k saturation or CC overflow the postprocess reruns with
        4x the capacity (the probability map stays in HBM), so detections
        are never silently dropped — same guarantee as ``nms()`` /
        ``label_components()``.
        """
        return self.postprocess(self.forward(volume), valid_lo, valid_hi)
