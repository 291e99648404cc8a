"""Volume-sharded inference, NMS, and CC with device-to-device halo exchange.

This is the mesh analog of flypylib's inference-side parallelism
(volume blocks split across GPU threads, SURVEY.md section 3.2) and the
"spatial sequence-parallelism" called for by SURVEY.md sections 2.3/5 and
eval configs 2/5 [B:8][B:11]:

- the volume is sharded along z (1-D mesh), z and y (2-D mesh), or z, y
  and x (3-D mesh) over the named mesh axes;
- each shard exchanges ``context``-deep boundary slabs with its neighbors
  via ``lax.ppermute`` (device-to-device sends, not host round-trips); the
  y exchange ships the *z-extended* block and the x exchange ships the
  *z+y-extended* block, so diagonal/corner data arrives via the multi-hop
  z-then-y-then-x path — every shard sees exactly the monolithic
  neighborhood;
- edge shards substitute the host-computed reflect padding (ONE reflect
  pad of the original volume — the single-reflect rule — zero-extended
  past the shard grid, where values only feed cropped outputs);
- the fully-convolutional forward then runs per shard, producing exactly
  its block of the global probability map — bitwise equal to a monolithic
  run because every conv is VALID;
- sharded NMS repeats the same halo trick with the NMS window and extracts
  per-shard top-k candidates with *global* coordinates, so the merge is a
  trivial host-side concatenation of tiny detection lists (the "NMS merge
  over the interconnect" of [B:11] — the map itself never moves);
- sharded CC labels each block on device and merges fragments across the
  shard-grid seams with the shared union-find
  (flypylib_tpu.ops.components.merge_component_fragments).

Volumes thinner than ``n_shards * context`` along a sharded dim no longer
refuse: the shard grid extends past the volume (extension is -inf for
NMS/CC and zero-fill for inference, cropped from every result), so the
API is total in volume shape.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from flypylib_tpu.io.synapses import Tbars
from flypylib_tpu.models.zoo import ModelSpec
from flypylib_tpu.ops.host_reference import sort_detections
from flypylib_tpu.utils import ceil_div, to3d


def _axes_tuple(axis) -> tuple[str, ...]:
    """Mesh axis names sharding (z,), (z, y), or (z, y, x)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if len(axes) not in (1, 2, 3):
        raise ValueError(f"axis must name 1-3 mesh axes, got {axes}")
    return axes


# ---------------------------------------------------------------------------
# Multi-process (multi-host) staging.  Single-process keeps the plain
# local transfers; with jax.distributed initialized, host-global numpy
# must become GLOBAL jax.Arrays before entering a global-mesh jit
# (host-local inputs to a global-mesh jit are correct single-process
# only), and non-fully-addressable outputs must be
# allgathered instead of device_get.


def _stage_global(arr: np.ndarray, mesh: Mesh, pspec: P):
    """Host numpy -> device array for a mesh jit.

    Multi-process: builds the global array shard-by-shard via
    ``jax.make_array_from_callback`` — every process holds the same
    host-global ``arr`` (SPMD convention, same as the train path) and
    uploads ONLY the shards its own devices hold."""
    if jax.process_count() <= 1:
        return jnp.asarray(arr)
    from jax.sharding import NamedSharding

    return jax.make_array_from_callback(
        arr.shape, NamedSharding(mesh, pspec), lambda idx: arr[idx]
    )


def _host_gather(tree):
    """``device_get`` that also works for non-fully-addressable global
    arrays (multi-process): allgathers each output to every host, so the
    downstream host-side merge runs identically on all processes."""
    if jax.process_count() <= 1:
        return jax.device_get(tree)
    from jax.experimental import multihost_utils

    return jax.tree_util.tree_map(
        lambda x: np.asarray(
            multihost_utils.process_allgather(x, tiled=True)
        ),
        tree,
    )


def _host_replicated(variables):
    """Model variables as a host pytree: multi-process jit treats numpy
    leaves as replicated-by-convention; committed single-device arrays
    would be rejected by a global-mesh jit."""
    if jax.process_count() <= 1:
        return variables
    return jax.device_get(variables)


def _exchange_extend(x, lo_pad, hi_pad, dlo, dhi, axis_name, dim):
    """Extend ``x`` along array dim ``dim`` with neighbor halos exchanged
    over mesh axis ``axis_name``; edge shards take the provided pads."""
    n = lax.axis_size(axis_name)
    i = lax.axis_index(axis_name)
    size = x.shape[dim]
    parts = []
    if dlo:
        down = [(j, j + 1) for j in range(n - 1)]
        lo = lax.ppermute(
            lax.slice_in_dim(x, size - dlo, size, axis=dim), axis_name, down
        )
        parts.append(jnp.where(i == 0, lo_pad, lo))
    parts.append(x)
    if dhi:
        up = [(j + 1, j) for j in range(n - 1)]
        hi = lax.ppermute(
            lax.slice_in_dim(x, 0, dhi, axis=dim), axis_name, up
        )
        parts.append(jnp.where(i == n - 1, hi_pad, hi))
    return jnp.concatenate(parts, axis=dim) if len(parts) > 1 else x


def _shard_extent(v: int, n: int, minimum: int, spec: ModelSpec | None):
    """Per-shard extent along a sharded dim: >= ceil(v/n), >= minimum, and
    (for models) aligned so shard starts preserve the packing/pooling
    phase and shard inputs are valid model sizes."""
    s = max(ceil_div(v, n), minimum, 1)
    if spec is not None and spec.size_multiple > 1:
        mult = spec.size_multiple
        s = ceil_div(s, mult) * mult
        if not spec.is_valid_size(s + 2 * spec.context):
            raise ValueError(
                f"model {spec.name}: no shard extent with aligned starts "
                f"gives a valid input size (size_multiple={mult}, "
                f"size_offset={spec.size_offset}, context={spec.context})"
            )
    return s


def sharded_infer(
    spec: ModelSpec,
    variables,
    volume: np.ndarray,
    mesh: Mesh,
    axis="space",
    pad_mode: str = "reflect",
    tile_z: int | None = None,
    tile_out: int | None = None,
    tile_batch: int = 8,
):
    """Volume-sharded whole-volume inference over 1, 2, or 3 mesh axes.

    ``axis`` is a mesh axis name (z-sharding), a pair ``(az, ay)`` (z and
    y sharding — xy footprints shrink with the mesh, so pods scale past
    what z-only slabs allow), or a triple ``(az, ay, ax)`` (full 3-D
    blocks — the smallest per-shard footprint, for pod meshes on big
    volumes).  Returns the full probability map as a sharded global jax
    array (same shape as ``volume``).  By default each shard's forward
    runs over its whole block; pass ``tile_z`` to bound per-shard
    activation memory — the shard then scans over z-subtiles in HBM, so
    arbitrarily large blocks fit (pod-scale volumes, eval config 5
    [B:11]).

    Multi-process (multi-host pod) ready: with ``jax.distributed``
    initialized, every process passes the same host-global ``volume``
    (SPMD convention) — staging uploads only each process's own shards
    (``_stage_global``) and downstream :func:`sharded_nms` /
    :func:`sharded_components` allgather their tiny candidate lists so
    every host computes the identical detection list (executed across
    2 real processes in tests/test_distributed.py).

    ``tile_out`` switches the per-shard forward to the batched
    small-cube tile sweep (``tile_batch`` tiles per dispatch) — the
    regime the single-device streaming engine runs.  Tile starts stay aligned to
    the model's ``size_multiple`` relative to the GLOBAL volume (shard
    extents are already aligned), so sharded == monolithic stays
    bitwise.  Mutually exclusive with ``tile_z``.
    """
    axes = _axes_tuple(axis)
    az = axes[0]
    ay = axes[1] if len(axes) > 1 else None
    ax_ = axes[2] if len(axes) > 2 else None
    nz = mesh.shape[az]
    ny = mesh.shape[ay] if ay else 1
    nx = mesh.shape[ax_] if ax_ else 1
    c = spec.context
    vol = np.asarray(volume)
    if vol.dtype != np.uint8:
        # uint8 stays uint8 on the wire AND in the host staging copy
        # (4x less traffic/RAM; the model casts in-graph, and uint8
        # values are exact in f32/bf16, so results are bitwise
        # identical to a host-side f32 cast — same rule as
        # TiledInference.infer); everything else canonicalizes to f32
        vol = vol.astype(np.float32)
    vz, vy, vx = vol.shape

    sz = _shard_extent(vz, nz, c, spec)
    sy = _shard_extent(vy, ny, c, spec) if ay else vy
    sx = _shard_extent(vx, nx, c, spec) if ax_ else vx
    vz_p, vy_p, vx_p = nz * sz, ny * sy, nx * sx
    if tile_z is not None:
        if tile_out is not None:
            raise ValueError("pass tile_z or tile_out, not both")
        if sz % tile_z != 0:
            raise ValueError(f"tile_z {tile_z} must divide z-extent {sz}")
        if spec.size_multiple > 1 and tile_z % spec.size_multiple != 0:
            raise ValueError(
                f"tile_z {tile_z} must be a multiple of "
                f"{spec.size_multiple} for packing/pooling-phase alignment"
            )
    if tile_out is not None:
        mult = max(spec.size_multiple, 1)
        if tile_out % mult != 0:
            raise ValueError(
                f"tile_out {tile_out} must be a multiple of {mult} for "
                "packing/pooling-phase alignment"
            )
        if not spec.is_valid_size(tile_out + 2 * c):
            raise ValueError(
                f"tile_out {tile_out} + 2*context is not a valid model "
                "input size"
            )

    # ONE reflect pad of the original volume (exactly the monolithic
    # padding), zero-extended to the shard grid: every output voxel z<vz,
    # y<vy, x<vx reads only monolithic values; extension values feed
    # outputs that are cropped below.
    mono = np.pad(vol, c, mode=pad_mode) if c else vol
    full = np.zeros(
        (vz_p + 2 * c, vy_p + 2 * c, vx_p + 2 * c), vol.dtype
    )
    full[: vz + 2 * c, : vy + 2 * c, : vx + 2 * c] = mono
    # sharded dims carry their halo via exchange (work excludes the pad);
    # unsharded dims keep the host pad inline
    xspec = ax_ if ax_ else None
    ysl = slice(c, c + vy_p) if ay else slice(0, vy_p + 2 * c)
    xsl = slice(c, c + vx_p) if ax_ else slice(0, vx_p + 2 * c)
    work = _stage_global(full[c : c + vz_p, ysl, xsl], mesh,
                         P(az, ay, xspec))
    zlo = _stage_global(full[:c, ysl, xsl], mesh, P(None, ay, xspec))
    zhi = _stage_global(full[c + vz_p :, ysl, xsl], mesh,
                        P(None, ay, xspec))
    extra = ()
    if ay:
        # y-edge pads cover the full z-extended range: shards slice their
        # own (sz + 2c)-deep window by mesh position
        extra += (
            _stage_global(full[:, :c, xsl], mesh, P(None, None, xspec)),
            _stage_global(full[:, c + vy_p :, xsl], mesh,
                          P(None, None, xspec)),
        )
    if ax_:
        # x-edge pads cover the full z- AND y-extended ranges (the x
        # exchange runs last, on the z+y-extended block)
        extra += (
            _stage_global(full[:, :, :c], mesh, P()),
            _stage_global(full[:, :, c + vx_p :], mesh, P()),
        )

    def fwd_tiled(variables, x):
        """Batched small-cube tile sweep over one shard's halo-extended
        block — identical structure to TiledInference.run_device, run
        INSIDE shard_map so every chip works the fast conv regime."""
        tout = tile_out
        tin = tout + 2 * c
        bshape = (x.shape[0] - 2 * c, x.shape[1] - 2 * c,
                  x.shape[2] - 2 * c)
        starts, padded = [], []
        for s in bshape:
            k = max(0, ceil_div(s - tout, tout))
            starts.append([i * tout for i in range(k + 1)])
            padded.append(k * tout + tout)
        # zero-extend so the static grid fits (extension feeds only
        # cropped output voxels — same rule as TiledInference)
        x = jnp.pad(x, [(0, p + 2 * c - q) for p, q in
                        zip(padded, x.shape)])
        corners = np.asarray(
            [(z, y, w) for z in starts[0] for y in starts[1]
             for w in starts[2]], np.int32,
        )
        B = min(tile_batch, len(corners))
        nbat = ceil_div(len(corners), B)
        corners = np.concatenate(
            [corners, np.repeat(corners[-1:], nbat * B - len(corners),
                                axis=0)]
        ).reshape(nbat, B, 3)

        def body(out, cb):
            tiles = jax.vmap(
                lambda cc_: lax.dynamic_slice(
                    x, (cc_[0], cc_[1], cc_[2]), (tin, tin, tin)
                )
            )(cb)
            logits = spec.module.apply(
                variables, tiles[..., None], train=False
            )
            probs = jax.nn.sigmoid(logits[..., 0])

            def write(out, args):
                tile, cc_ = args
                return lax.dynamic_update_slice(
                    out, tile, (cc_[0], cc_[1], cc_[2])
                ), None

            out, _ = lax.scan(write, out, (probs, cb))
            return out, None

        out0 = jnp.zeros(tuple(padded), jnp.float32)
        out, _ = lax.scan(body, out0, jnp.asarray(corners))
        return out[: bshape[0], : bshape[1], : bshape[2]]

    def fwd(variables, x):
        if tile_out is not None:
            return fwd_tiled(variables, x)
        if tile_z is None:
            logits = spec.module.apply(
                variables, x[None, ..., None], train=False
            )
            return jax.nn.sigmoid(logits[0, ..., 0])

        def body(out, t):
            xt = lax.dynamic_slice(
                x, (t * tile_z, 0, 0),
                (tile_z + 2 * c, x.shape[1], x.shape[2]),
            )
            logits = spec.module.apply(
                variables, xt[None, ..., None], train=False
            )
            out = lax.dynamic_update_slice(
                out, jax.nn.sigmoid(logits[0, ..., 0]), (t * tile_z, 0, 0)
            )
            return out, None

        out0 = jnp.zeros(
            (x.shape[0] - 2 * c, x.shape[1] - 2 * c, x.shape[2] - 2 * c),
            jnp.float32,
        )
        out, _ = lax.scan(body, out0, jnp.arange(sz // tile_z))
        return out

    def fn(variables, slab, zlo_p, zhi_p, *pads):
        x = _exchange_extend(slab, zlo_p, zhi_p, c, c, az, dim=0)
        k = 0
        if ay:
            zi = lax.axis_index(az)
            ylo_f, yhi_f = pads[:2]
            k = 2
            dims = (sz + 2 * c, c, x.shape[2])
            ylo = lax.dynamic_slice(ylo_f, (zi * sz, 0, 0), dims)
            yhi = lax.dynamic_slice(yhi_f, (zi * sz, 0, 0), dims)
            x = _exchange_extend(x, ylo, yhi, c, c, ay, dim=1)
        if ax_:
            zi = lax.axis_index(az)
            yi = lax.axis_index(ay)
            xlo_f, xhi_f = pads[k : k + 2]
            dims = (sz + 2 * c, sy + 2 * c, c)
            xlo = lax.dynamic_slice(xlo_f, (zi * sz, yi * sy, 0), dims)
            xhi = lax.dynamic_slice(xhi_f, (zi * sz, yi * sy, 0), dims)
            x = _exchange_extend(x, xlo, xhi, c, c, ax_, dim=2)
        return fwd(variables, x)

    in_specs = [P(), P(az, ay, xspec), P(None, ay, xspec),
                P(None, ay, xspec)]
    if ay:
        in_specs += [P(None, None, xspec)] * 2
    if ax_:
        in_specs += [P()] * 2
    out_spec = P(az, ay, xspec)

    out = jax.jit(shard_map(
        fn,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=out_spec,
        check_vma=False,
    ))(_host_replicated(variables), work, zlo, zhi, *extra)
    return out[:vz, :vy, :vx]


def sharded_nms(
    prob,
    mesh: Mesh,
    axis="space",
    window=3,
    threshold: float = 0.5,
    max_per_shard: int = 1024,
) -> Tbars:
    """NMS on a sharded probability map with halo exchange (1-D, 2-D,
    or 3-D spatial mesh; see :func:`sharded_infer` for the ``axis``
    convention).

    Per-shard candidates are extracted with *global* coordinates; the
    cross-shard merge is exact because each shard's max-filter sees the
    true neighbor planes via the halo — a voxel at a shard seam is a
    candidate iff it would be in a monolithic NMS.  Saturated shards grow
    and retry, so no candidate is silently dropped.
    """
    axes = _axes_tuple(axis)
    az = axes[0]
    ay = axes[1] if len(axes) > 1 else None
    ax_ = axes[2] if len(axes) > 2 else None
    nz = mesh.shape[az]
    ny = mesh.shape[ay] if ay else 1
    nx = mesh.shape[ax_] if ax_ else 1
    wz, wy, wx = to3d(window)
    hzl, hzh = wz // 2, wz - 1 - wz // 2
    hyl, hyh = (wy // 2, wy - 1 - wy // 2) if ay else (0, 0)
    hxl, hxh = (wx // 2, wx - 1 - wx // 2) if ax_ else (0, 0)

    xspec0 = ax_ if ax_ else None
    is_global = isinstance(prob, jax.Array)
    if is_global:
        prob = prob.astype(jnp.float32)  # global op (multi-process safe)
    else:
        prob = np.asarray(prob, dtype=np.float32)
    vz, vy, vx = prob.shape
    sz = max(ceil_div(vz, nz), hzl, hzh, 1)
    sy = max(ceil_div(vy, ny), hyl, hyh, 1) if ay else vy
    sx = max(ceil_div(vx, nx), hxl, hxh, 1) if ax_ else vx
    vz_p, vy_p, vx_p = nz * sz, ny * sy, nx * sx
    if (vz_p, vy_p, vx_p) != (vz, vy, vx):
        pad_fn = jnp.pad if is_global else np.pad
        prob = pad_fn(
            prob, ((0, vz_p - vz), (0, vy_p - vy), (0, vx_p - vx)),
            constant_values=-np.inf,
        )
    if not is_global:
        prob = _stage_global(prob, mesh, P(az, ay, xspec0))
    max_per_shard = min(max_per_shard, sz * sy * sx)  # top_k k <= block

    negz = jnp.full((max(hzl, hzh), sy, sx), -jnp.inf, dtype=jnp.float32)
    negy = jnp.full(
        (sz + hzl + hzh, max(hyl, hyh, 1), sx), -jnp.inf,
        dtype=jnp.float32,
    )
    negx = jnp.full(
        (sz + hzl + hzh, sy + hyl + hyh, max(hxl, hxh, 1)), -jnp.inf,
        dtype=jnp.float32,
    )

    xspec = ax_ if ax_ else None
    grp = tuple(axes) if len(axes) > 1 else az
    in_specs = (P(az, ay, xspec),)
    out_specs = (P(grp, None), P(grp), P(grp))

    @functools.partial(
        shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    def fn(slab):
        zi = lax.axis_index(az)
        ext = _exchange_extend(
            slab, negz[:hzl], negz[:hzh], hzl, hzh, az, dim=0
        )
        if ay:
            ext = _exchange_extend(
                ext, negy[:, :hyl], negy[:, :hyh], hyl, hyh, ay, dim=1
            )
        if ax_:
            ext = _exchange_extend(
                ext, negx[:, :, :hxl], negx[:, :, :hxh], hxl, hxh, ax_,
                dim=2,
            )
        # separable max filter: valid passes where the halo provides the
        # padding, interior-padded passes elsewhere
        mf = lax.reduce_window(
            ext, -jnp.inf, lax.max, (wz, 1, 1), (1, 1, 1),
            [(0, 0), (0, 0), (0, 0)],
        )
        ypad = (0, 0) if ay else (wy // 2, wy - 1 - wy // 2)
        mf = lax.reduce_window(
            mf, -jnp.inf, lax.max, (1, wy, 1), (1, 1, 1),
            [(0, 0), ypad, (0, 0)],
        )
        xpad = (0, 0) if ax_ else (wx // 2, wx - 1 - wx // 2)
        mf = lax.reduce_window(
            mf, -jnp.inf, lax.max, (1, 1, wx), (1, 1, 1),
            [(0, 0), (0, 0), xpad],
        )
        mask = (slab == mf) & (slab >= threshold)
        flat = jnp.where(mask.reshape(-1), slab.reshape(-1), -jnp.inf)
        conf, idx = lax.top_k(flat, max_per_shard)
        valid = conf > -jnp.inf
        z = idx // (sy * sx) + zi * sz  # global z
        rem = idx % (sy * sx)
        y = rem // sx
        x = rem % sx
        if ay:
            y = y + lax.axis_index(ay) * sy
        if ax_:
            x = x + lax.axis_index(ax_) * sx
        locs = jnp.stack([z, y, x], axis=1).astype(jnp.int32)
        return locs, conf, valid

    locs, conf, valid = _host_gather(jax.jit(fn)(prob))  # one transfer
    n_shards = nz * ny * nx
    if (
        max_per_shard < sz * sy * sx
        and valid.reshape(n_shards, -1).all(axis=1).any()
    ):
        # a shard saturated its top-k: grow and retry so no candidate is
        # silently dropped (same self-healing as ops.nms.nms)
        return sharded_nms(
            prob[:vz, :vy, :vx], mesh, axis, window, threshold,
            max_per_shard * 4,
        )
    keep = (
        valid & (locs[:, 0] < vz) & (locs[:, 1] < vy) & (locs[:, 2] < vx)
    )
    return sort_detections(locs[keep].astype(np.float64), conf[keep])


def sharded_components(
    prob,
    mesh: Mesh,
    axis="space",
    threshold: float = 0.5,
    max_components: int = 1024,
) -> Tbars:
    """Connected components on a sharded probability map with an exact
    cross-shard seam merge (1-D, 2-D, or 3-D spatial mesh).

    Each shard labels its block on device (flypylib_tpu.ops.components
    core) and exports, besides its compacted component stats, the
    converged label ids of its boundary planes.  The host then unions
    components whose boundary voxels are 6-adjacent across a seam via the
    shared :func:`~flypylib_tpu.ops.components.merge_component_fragments`
    union-find, so centroids and confidences equal a monolithic run's
    exactly.  Overflowing shards grow the per-shard budget and retry.
    """
    from flypylib_tpu.ops.components import (
        cc_label_and_extract,
        merge_component_fragments,
    )

    axes = _axes_tuple(axis)
    az = axes[0]
    ay = axes[1] if len(axes) > 1 else None
    ax_ = axes[2] if len(axes) > 2 else None
    nz = mesh.shape[az]
    ny = mesh.shape[ay] if ay else 1
    nx = mesh.shape[ax_] if ax_ else 1
    is_global = isinstance(prob, jax.Array)
    if is_global:
        prob = prob.astype(jnp.float32)  # global op (multi-process safe)
    else:
        prob = np.asarray(prob, dtype=np.float32)
    vz, vy, vx = prob.shape
    sz = max(ceil_div(vz, nz), 1)
    sy = max(ceil_div(vy, ny), 1) if ay else vy
    sx = max(ceil_div(vx, nx), 1) if ax_ else vx
    vz_p, vy_p, vx_p = nz * sz, ny * sy, nx * sx
    if (vz_p, vy_p, vx_p) != (vz, vy, vx):
        pad_fn = jnp.pad if is_global else np.pad
        prob = pad_fn(
            prob, ((0, vz_p - vz), (0, vy_p - vy), (0, vx_p - vx)),
            constant_values=-np.inf,
        )
    if not is_global:
        prob = _stage_global(prob, mesh, P(az, ay, ax_ if ax_ else None))
    block_nvox = sz * sy * sx
    # cc_label_and_extract clamps K to the block voxel count internally;
    # mirror that here so the stacked output shapes stay (n_shards, K)
    K = min(max_components, block_nvox)

    xspec = ax_ if ax_ else None
    in_specs = (P(az, ay, xspec),)
    ax0 = tuple(axes) if len(axes) > 1 else az
    g1, g2 = P(ax0), P(ax0, None)
    # x faces are only exported when x is sharded: with nx == 1 the
    # merge can never use them and they'd just ride the wire
    out_specs = (g1, g2, g1, g1, g1, g1, g2, g2, g2, g2) + (
        (g2, g2) if ax_ else ()
    )

    @functools.partial(
        shard_map, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    def fn(slab):
        uniq, sums, count, conf, valid, over, lab = cc_label_and_extract(
            slab, threshold, K
        )
        faces = (lab[0], lab[sz - 1], lab[:, 0], lab[:, sy - 1])
        if ax_:
            faces = faces + (lab[:, :, 0], lab[:, :, sx - 1])
        return (uniq, sums, count, conf, valid, over[None]) + faces

    res = _host_gather(jax.jit(fn)(prob))  # one transfer
    if ax_:
        (uniq, sums, count, conf, valid, over,
         zlo, zhi, ylo, yhi, xlo, xhi) = res
    else:
        uniq, sums, count, conf, valid, over, zlo, zhi, ylo, yhi = res
        xlo = xhi = None
    if bool(np.asarray(over).any()):
        return sharded_components(
            prob[:vz, :vy, :vx], mesh, axis, threshold, max_components * 4
        )

    grid = (nz, ny, nx)
    uniq = np.asarray(uniq).reshape(*grid, K)
    sums = np.array(sums, np.float64).reshape(*grid, K, 3)
    count = np.asarray(count, np.float64).reshape(*grid, K)
    conf = np.asarray(conf).reshape(*grid, K)
    valid = np.asarray(valid).reshape(*grid, K)
    zlo = np.asarray(zlo).reshape(*grid, sy, sx)
    zhi = np.asarray(zhi).reshape(*grid, sy, sx)
    ylo = np.asarray(ylo).reshape(*grid, sz, sx)
    yhi = np.asarray(yhi).reshape(*grid, sz, sx)
    if ax_:
        xlo = np.asarray(xlo).reshape(*grid, sz, sy)
        xhi = np.asarray(xhi).reshape(*grid, sz, sy)

    # globalize coordinate sums by each shard's corner
    blocks = {}
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                i = (iz, iy, ix)
                s = sums[i].copy()
                s[:, 0] += iz * sz * count[i]
                s[:, 1] += iy * sy * count[i]
                s[:, 2] += ix * sx * count[i]
                blocks[i] = {
                    "uniq": uniq[i],
                    "sums": s,
                    "count": count[i],
                    "conf": conf[i],
                    "valid": valid[i],
                    "faces": [
                        zlo[i], zhi[i],
                        ylo[i], yhi[i],
                        xlo[i] if ax_ else None,
                        xhi[i] if ax_ else None,
                    ],
                }

    det = merge_component_fragments(blocks, block_nvox)
    if len(det) == 0:
        return det
    keep = (
        (det.locs[:, 0] < vz) & (det.locs[:, 1] < vy)
        & (det.locs[:, 2] < vx)
    )
    return Tbars(locs=det.locs[keep], conf=det.conf[keep])
