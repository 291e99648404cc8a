"""Overlap-tiled fully-convolutional whole-volume inference.

Parity: flypylib fplnetwork.infer (SURVEY.md section 3.2): pad the volume
by the model's valid-conv context, partition into blocks, run the
fully-convolutional net per block, stitch outputs into the full probability
map.

Design (SURVEY.md section 7.2 step 4):

- **Static tile shapes**: every tile has the same input shape, so XLA
  compiles the forward exactly once; the tile grid extends past the volume
  (extra voxels cropped) instead of changing shapes at edges.
- **Pooling-phase alignment**: tile starts are multiples of the model's
  ``size_multiple`` (2^levels for pooling U-Nets), so every tile sees the
  same pooling grid phase as a monolithic run — tiled output is bitwise
  identical to monolithic on the interior, including in tile overlaps.
- **Batched tiles**: tiles are stacked on a batch axis, one dispatch per
  batch.
- **Double-buffered host->device feed**: JAX dispatch is async — the next
  tile batch uploads with ``jax.device_put`` while the current batch
  computes, so the feed rides under compute.
- **On-device stitching**: with ``keep_on_device=True`` the probability map
  is assembled on device with donated ``dynamic_update_slice`` so downstream
  NMS/CC never pull the map to host (north star [B:5]).

Padding semantics: the volume is reflect-padded by exactly ``context`` on
every face (matching a monolithic run), then zero-extended on the high side
to fill the static tile grid; the extension only feeds output voxels that
are cropped away, so it never affects the returned map.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from flypylib_tpu.models.zoo import ModelSpec
from flypylib_tpu.utils import ceil_div, to3d


class TiledInference:
    def __init__(
        self,
        spec: ModelSpec,
        variables,
        tile_out: int = 64,
        tile_batch: int = 1,
        pad_mode: str = "reflect",
    ):
        self.spec = spec
        self.variables = variables
        ctx = spec.context
        # choose tile input size valid for the model, derive the true tile_out
        tin = spec.valid_size(tile_out + 2 * ctx)
        self.tile_in = tin
        self.tile_out = tin - 2 * ctx
        self.ctx = ctx
        self.tile_batch = tile_batch
        self.pad_mode = pad_mode
        # tile starts must preserve pooling phase: stride multiple of this
        self.align = spec.size_multiple
        self.stride = (self.tile_out // self.align) * self.align
        if self.stride <= 0:
            raise ValueError(
                f"tile_out {self.tile_out} smaller than alignment {self.align}"
            )

        @jax.jit
        def forward(variables, x):
            # x: (B, tin, tin, tin) float32 -> (B, tout, tout, tout) prob f32
            logits = spec.module.apply(variables, x[..., None], train=False)
            return jax.nn.sigmoid(logits[..., 0])

        self._forward = forward

        @functools.partial(jax.jit, donate_argnums=(0,))
        def scatter(out, tiles, corners):
            def body(out, args):
                tile, corner = args
                return (
                    jax.lax.dynamic_update_slice(
                        out, tile, (corner[0], corner[1], corner[2])
                    ),
                    None,
                )

            out, _ = jax.lax.scan(body, out, (tiles, corners))
            return out

        self._scatter = scatter

        @functools.partial(jax.jit, static_argnames=("out_shape",))
        def run_device(variables, padded, corners, out_shape):
            """Whole-volume inference in ONE dispatch: the padded volume
            lives in HBM and a lax.scan slices, runs, and stitches every
            tile batch on device — no per-tile host round-trips."""
            out = jnp.zeros(out_shape, dtype=jnp.float32)

            def body(out, corner_batch):
                tiles = jax.vmap(
                    lambda c: jax.lax.dynamic_slice(
                        padded, (c[0], c[1], c[2]), (tin, tin, tin)
                    )
                )(corner_batch)
                logits = spec.module.apply(
                    variables, tiles[..., None], train=False
                )
                probs = jax.nn.sigmoid(logits[..., 0])

                def write(out, args):
                    tile, c = args
                    return (
                        jax.lax.dynamic_update_slice(
                            out, tile, (c[0], c[1], c[2])
                        ),
                        None,
                    )

                out, _ = jax.lax.scan(write, out, (probs, corner_batch))
                return out, None

            out, _ = jax.lax.scan(body, out, corners)
            return out

        self._run_device = run_device

    def _axis_plan(self, size: int) -> tuple[list[int], int]:
        """(aligned tile starts, padded output extent) for one axis."""
        k = max(0, ceil_div(size - self.tile_out, self.stride))
        starts = [i * self.stride for i in range(k + 1)]
        return starts, k * self.stride + self.tile_out

    def plan(self, shape):
        """(tile corners, padded output shape) for a (z, y, x) volume."""
        shape = to3d(shape)
        per_axis = [self._axis_plan(s) for s in shape]
        corners = [
            (z, y, x)
            for z in per_axis[0][0]
            for y in per_axis[1][0]
            for x in per_axis[2][0]
        ]
        padded_shape = tuple(p[1] for p in per_axis)
        return corners, padded_shape

    def infer(
        self,
        volume: np.ndarray,
        keep_on_device: bool = False,
        host_stream: bool = False,
    ):
        """Full-volume probability map, same shape as ``volume``.

        Default path uploads the (padded) volume to HBM once and runs the
        whole tile sweep in a single dispatch (``host_stream=False``);
        set ``host_stream=True`` for volumes too large to hold padded
        input + output in HBM simultaneously — tiles are then fed from
        host with double buffering.
        """
        vol = np.asarray(volume)
        if vol.dtype != np.uint8:
            # uint8 stays uint8 on the wire (4x less host->HBM traffic;
            # uint8 -> f32/bf16 on device is exact, so results are
            # bitwise identical to a host-side f32 cast); everything
            # else is canonicalized to f32
            vol = vol.astype(np.float32)
        c = self.ctx
        if self.pad_mode == "none":
            # caller passed a PRE-PADDED window (e.g. a mult-aligned slab
            # of the monolithic reflect-padded volume, see
            # ops/matching.voxel_pr_streaming) — output shrinks by 2*ctx
            # per axis and the pooling phase is the caller's to align
            shape = tuple(s - 2 * c for s in vol.shape)
            if any(s <= 0 for s in shape):
                raise ValueError(
                    f"pre-padded window {vol.shape} smaller than "
                    f"2*context={2 * c}"
                )
            padded = vol
        else:
            shape = vol.shape
        corners, out_shape = self.plan(shape)

        # stage 1: context halo (reflect — matches monolithic semantics)
        if self.pad_mode != "none":
            padded = np.pad(vol, c, mode=self.pad_mode) if c else vol
        # stage 2: zero-extend high side to the static tile grid (cropped
        # away from the result, so values are irrelevant)
        extra = [(0, os - s) for s, os in zip(shape, out_shape)]
        padded = np.pad(padded, extra)

        B = self.tile_batch
        tin = self.tile_in
        n = len(corners)
        n_batches = ceil_div(n, B)
        # pad the last batch by repeating the final corner: duplicate writes
        # are bitwise identical, so stitch order is irrelevant
        corners_padded = corners + [corners[-1]] * (n_batches * B - n)

        if not host_stream:
            corner_arr = jnp.asarray(
                np.asarray(corners_padded, dtype=np.int32).reshape(
                    n_batches, B, 3
                )
            )
            out = self._run_device(
                self.variables, jnp.asarray(padded), corner_arr, out_shape
            )
            out = out[: shape[0], : shape[1], : shape[2]]
            return out if keep_on_device else np.asarray(out)

        def make_batch(bi):
            cs = corners_padded[bi * B : (bi + 1) * B]
            tiles = np.stack(
                [
                    padded[z : z + tin, y : y + tin, x : x + tin]
                    for (z, y, x) in cs
                ]
            )
            return tiles, np.asarray(cs, dtype=np.int32)

        out = jnp.zeros(out_shape, dtype=jnp.float32)
        # double-buffer: upload batch i+1 while batch i computes
        next_tiles, next_corners = make_batch(0)
        next_dev = jax.device_put(next_tiles)
        for bi in range(n_batches):
            tiles_dev = next_dev
            corners_np = next_corners
            if bi + 1 < n_batches:
                next_tiles, next_corners = make_batch(bi + 1)
                next_dev = jax.device_put(next_tiles)
            probs = self._forward(self.variables, tiles_dev)
            out = self._scatter(out, probs, jnp.asarray(corners_np))

        out = out[: shape[0], : shape[1], : shape[2]]
        if keep_on_device:
            return out
        return np.asarray(out)


def infer_volume(
    spec: ModelSpec,
    variables,
    volume: np.ndarray,
    tile_out: int = 64,
    tile_batch: int = 1,
    keep_on_device: bool = False,
):
    """One-shot convenience wrapper around TiledInference."""
    return TiledInference(
        spec, variables, tile_out=tile_out, tile_batch=tile_batch
    ).infer(volume, keep_on_device=keep_on_device)


def tiling_regime(spec: ModelSpec) -> str:
    """``"cover"`` (pooling topologies want one big tile) or ``"grid"``
    (conv stacks want batched small tiles).  From the module topology,
    overridable via ``spec.metadata["tiling"]``."""
    regime = spec.metadata.get("tiling")
    if regime is not None:
        return regime
    from flypylib_tpu.models.zoo import UNetValid
    from flypylib_tpu.ops.packed_unet import PackedUNet

    return (
        "cover"
        if isinstance(spec.module, (UNetValid, PackedUNet))
        else "grid"
    )


def default_tiling(
    spec: ModelSpec, vol_shape, max_tile_in: int = 428
) -> tuple[int, int]:
    """Model-aware default ``(tile_out, tile_batch)`` for a volume.

    Two regimes:

    - **Pooling topologies** (the valid-conv U-Net, plain or packed):
      grids pay 1.9-3x halo redundancy, and pooling shrinks activation
      footprints enough that big tiles fit — ONE covering tile whenever
      its input is under ``max_tile_in``.  Larger volumes get the
      largest valid tile under the cap, batch 1.
    - **Dilated conv stacks**: batched small-spatial tiles despite halo
      redundancy — 64-wide tiles, batch up to 8 bounded by the grid
      size.

    The cap (tile input 428), the tile 64 and the batch bound were
    swept on the platform the package was first built for; they are
    unmeasured on the GPU and stay the defaults until a sweep there
    replaces them.

    The regime comes from the module topology (``UNetValid`` /
    ``PackedUNet``); custom specs can force it via
    ``metadata["tiling"] = "cover"`` or ``"grid"``.
    """
    dims = to3d(vol_shape)
    ctx = spec.context
    if tiling_regime(spec) == "cover":
        ext = max(dims)
        if spec.valid_size(ext + 2 * ctx) <= max_tile_in:
            return ext, 1
        # largest valid tile input under the cap
        tin = max_tile_in
        while tin > spec.min_size and not spec.is_valid_size(tin):
            tin -= 1
        return max(tin - 2 * ctx, spec.size_multiple), 1
    tile = 64
    n_tiles = 1
    for d in dims:
        n_tiles *= max(1, -(-d // tile))
    return tile, max(1, min(8, n_tiles))


def grid_tiling_min_cost(
    spec: ModelSpec, vol_shape, max_tile_in: int = 428
) -> tuple[int, int]:
    """``(tile_out, tile_batch)`` minimizing total conv input voxels
    (tile count x tile_in^3) for a whole-volume tile grid, over valid
    phase-aligned tile sizes with ``tile_in <= max_tile_in``.

    Used by the shared-forward streaming mode for pooling ("cover")
    topologies, where the forward tiling is decoupled from the ROI
    postprocess geometry: the cost of a covering-tile-per-ROI sweep is
    dominated by halo redundancy (2.5x at 1k^3 with core 256), while a
    cost-minimizing grid over the whole volume pays only its own tile
    halos + overshoot (e.g. 27 tiles of tin 388 = 1.47x at 1k^3).
    Batch stays 1 (big pooled tiles)."""
    dims = to3d(vol_shape)
    ctx = spec.context
    mult = max(spec.size_multiple, 1)
    best, best_cost = None, None
    t = mult
    while True:
        tin = spec.valid_size(t + 2 * ctx)
        if tin > max_tile_in:
            break
        tout = tin - 2 * ctx
        stride = (tout // mult) * mult
        if stride > 0:
            n = 1
            for d in dims:
                k = max(0, ceil_div(max(0, d - tout), stride))
                n *= k + 1
            cost = n * tin**3
            # <=: prefer the LARGER tile on cost ties (fewer dispatches)
            if best is None or cost <= best_cost:
                best, best_cost = tout, cost
        t = tout + mult  # skip to the next distinct valid size
    if best is None:
        return default_tiling(spec, vol_shape, max_tile_in)
    return best, 1
