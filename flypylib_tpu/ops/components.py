"""Connected components — on-device (XLA) labeling + centroid extraction.

Parity: flypylib fplobjdetect's CC path — ``scipy.ndimage.label`` on the
thresholded probability map with 6-connectivity, detections at component
centroids with the component max probability as confidence (SURVEY.md
section 3.3; semantics pinned in flypylib_tpu.ops.host_reference).

XLA has no native CC, so labeling runs as an iterative fixed point
(SURVEY.md section 7.3): each voxel's label starts as its own flat index
and every sweep takes the min over 6-neighbors within the mask.  Sweeps
are pure shifted-element-wise mins (no gathers); several
sweeps run between convergence checks to amortize the check.  An optional
pointer-jumping step (``label = label[label]``, a gather) contracts long
chains for high-diameter masks — off by default because random-access
gathers are slow and synapse-scale components have small diameter.

Extraction stays on device with static shapes: component roots (voxels
whose label is their own index) are compacted with ``lax.top_k`` over
negated flat indices — no full-volume sort — then centroids/conf come from
segment reductions keyed by ``searchsorted`` compact ids.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from flypylib_tpu.io.synapses import Tbars
from flypylib_tpu.ops.host_reference import sort_detections


def compact_true_indices(mask_flat: jax.Array, size: int) -> jax.Array:
    """First ``size`` True positions, ascending, padded with ``n``.

    Drop-in for ``jnp.nonzero(mask, size=..., fill_value=n)[0]`` — but
    without XLA's nonzero lowering (scatter-compacts the full volume)
    and without a flat cumsum+searchsorted (whose binary search does
    log2(n) rounds of random scalar gathers into the full-volume array).

    Three-level scheme; the full volume is touched by exactly ONE
    reduction pass, and every per-query step works on small or
    contiguous data (the previous two-level version's cost was
    materializing the full (R, 128) within-block cumsum —
    537 MB written and row-gathered):

    - reshape to (R, 128) blocks; ONE pass computes per-block counts
      (the bool blocks themselves are never cumsum'd in full);
    - group blocks into superblocks of 128; cumulative counts within
      each superblock (R/128 x 128) and a tiny superblock-offset array;
    - per query: binary-search the SMALL superblock offsets, row-gather
      the superblock's cumulative counts (512 B, contiguous) to pick the
      block by compare-count, then row-gather the block's RAW mask row
      (128 B) and resolve the in-block position from its local cumsum.

    The j-th candidate's flat index is the first position where the
    running count reaches j; queries past the total count return ``n``.
    """
    n = mask_flat.shape[0]
    M = 128
    if n <= (1 << 16) or size >= n:  # small cases: one-level is fine
        pos = jnp.cumsum(mask_flat.astype(jnp.int32))
        return jnp.searchsorted(
            pos, jnp.arange(1, size + 1, dtype=jnp.int32)
        ).astype(jnp.int32)
    pad = (-n) % M
    if pad:
        mask_flat = jnp.concatenate(
            [mask_flat, jnp.zeros((pad,), mask_flat.dtype)]
        )
    R = (n + pad) // M
    blk = mask_flat.reshape(R, M)  # bool; only selected rows get cumsum'd
    bsum = jnp.sum(blk, axis=1, dtype=jnp.int32)  # (R,) — the one pass
    S = 128
    pad2 = (-R) % S
    if pad2:
        bsum = jnp.concatenate([bsum, jnp.zeros((pad2,), jnp.int32)])
    R2 = (R + pad2) // S
    scum = jnp.cumsum(bsum.reshape(R2, S), axis=1)  # (R2, S)
    soff = jnp.cumsum(scum[:, -1])  # (R2,) superblock offsets — tiny
    q = jnp.arange(1, size + 1, dtype=jnp.int32)
    sid = jnp.searchsorted(soff, q).astype(jnp.int32)
    inb = sid < R2
    safe_s = jnp.minimum(sid, R2 - 1)
    sbase = jnp.where(safe_s > 0, soff[safe_s - 1], 0)
    srows = scum[safe_s]  # (size, S) contiguous row gather
    qs = (q - sbase)[:, None]
    # first block whose cumulative count reaches the query; padded/empty
    # blocks share their predecessor's cumulative value, so the compare
    # count lands on the earliest (real) block
    bpos = jnp.sum(srows < qs, axis=1, dtype=jnp.int32)
    blkid = safe_s * S + bpos
    safe_blk = jnp.minimum(blkid, R - 1)
    bbase = sbase + jnp.where(
        bpos > 0,
        jnp.take_along_axis(
            srows, jnp.maximum(bpos - 1, 0)[:, None], axis=1
        )[:, 0],
        0,
    )
    rows = blk[safe_blk].astype(jnp.int32)  # (size, M) raw-row gather
    rcum = jnp.cumsum(rows, axis=1)
    qq = (q - bbase)[:, None]
    pos_in = jnp.sum(rcum < qq, axis=1, dtype=jnp.int32)
    idx = safe_blk * M + pos_in
    return jnp.where(inb & (idx < n), idx, n).astype(jnp.int32)


def _neighbor_min(lab: jax.Array, mask: jax.Array, sentinel) -> jax.Array:
    """Min of label over the 6-neighborhood (self included), masked."""
    out = lab
    for axis in range(3):
        for shift in (1, -1):
            pad_cfg = [(0, 0, 0)] * 3
            pad_cfg[axis] = (1, 0, 0) if shift == 1 else (0, 1, 0)
            sl = [slice(None)] * 3
            sl[axis] = slice(None, -1) if shift == 1 else slice(1, None)
            shifted = lax.pad(lab[tuple(sl)], sentinel, pad_cfg)
            out = jnp.minimum(out, shifted)
    return jnp.where(mask, out, sentinel)


def cc_label_and_extract(
    prob: jax.Array,
    threshold,
    max_components: int,
    max_candidates: int | None = None,
    sweeps_per_check: int = 4,
    pointer_jump: bool = False,
):
    """Traceable CC core: label propagation + compacted extraction.

    Returns ``(uniq (K,) local root ids ascending, sums (K,3) coordinate
    sums, count (K,), conf (K,), valid (K,), overflowed (), lab (Z,Y,X)
    converged labels)`` — shared by components_device and the sharded
    seam-merging path (flypylib_tpu.parallel.halo.sharded_components).

    ``max_candidates`` bounds the number of above-threshold voxels (default
    16 * max_components); exceeding either bound sets ``overflowed``.
    Extraction compacts the candidate voxels first (one ``nonzero``), so
    the expensive segment reductions run over ``max_candidates`` elements
    instead of the whole volume — full-volume work is only the label
    sweeps and the compaction pass.
    """
    prob = prob.astype(jnp.float32)
    shape = prob.shape
    n = int(np.prod(shape))
    max_components = min(max_components, n)
    if max_candidates is None:
        max_candidates = 16 * max_components
    max_candidates = min(max_candidates, n)
    sentinel = jnp.int32(n)
    mask = prob >= threshold

    idx = jnp.arange(n, dtype=jnp.int32).reshape(shape)
    lab = jnp.where(mask, idx, sentinel)

    def jump(lab):
        flat = jnp.concatenate([lab.reshape(-1), sentinel[None]])
        return flat[lab]

    def body(state):
        lab, _ = state
        new = lab
        for _ in range(sweeps_per_check):
            new = _neighbor_min(new, mask, sentinel)
        if pointer_jump:
            new = jump(new)
        return new, jnp.any(new != lab)

    def cond(state):
        return state[1]

    lab, _ = lax.while_loop(cond, body, (lab, jnp.bool_(True)))

    roots = lab.reshape(-1)
    mflat = mask.reshape(-1)
    n_cand = jnp.sum(mflat, dtype=jnp.int32)

    # compact: indices of candidate voxels (padded with n)
    cand = compact_true_indices(mflat, max_candidates)
    valid_c = cand < n
    safe = jnp.minimum(cand, n - 1)
    roots_c = jnp.where(valid_c, roots[safe], sentinel)
    prob_c = jnp.where(valid_c, prob.reshape(-1)[safe], -jnp.inf)
    z_c = (safe // (shape[1] * shape[2])).astype(jnp.float32)
    y_c = ((safe // shape[2]) % shape[1]).astype(jnp.float32)
    x_c = (safe % shape[2]).astype(jnp.float32)

    rep_c = (roots_c == cand) & valid_c
    n_comp = jnp.sum(rep_c)
    overflowed = (n_comp > max_components) | (n_cand > max_candidates)

    # compact root ids without a sort: top_k over -index keeps the (<= K)
    # representative indices; descending -idx == ascending idx; invalid
    # slots become a huge ascending-compatible sentinel
    fill = jnp.iinfo(jnp.int32).min + 1
    key = jnp.where(rep_c, -cand, fill)
    neg_roots, _ = lax.top_k(key, max_components)
    uniq = -neg_roots  # ascending: real roots first, then ~2^31 sentinels
    seg = jnp.searchsorted(uniq, roots_c).astype(jnp.int32)

    num_segments = max_components + 1
    seg = jnp.where(valid_c, jnp.minimum(seg, num_segments - 1),
                    num_segments - 1)
    w = valid_c.astype(jnp.float32)
    count = jax.ops.segment_sum(w, seg, num_segments)
    sums = jnp.stack(
        [jax.ops.segment_sum(c * w, seg, num_segments)
         for c in (z_c, y_c, x_c)],
        axis=1,
    )
    conf = jax.ops.segment_max(prob_c, seg, num_segments)
    valid = (uniq < sentinel) & (count[:max_components] > 0)
    return (
        uniq,
        sums[:max_components],
        count[:max_components],
        conf[:max_components],
        valid,
        overflowed,
        lab,
    )


@functools.partial(
    jax.jit,
    static_argnames=("max_components", "max_candidates", "sweeps_per_check",
                     "pointer_jump"),
)
def components_device(
    prob: jax.Array,
    threshold=0.5,
    max_components: int = 1024,
    max_candidates: int | None = None,
    sweeps_per_check: int = 4,
    pointer_jump: bool = False,
):
    """On-device CC: returns (centroids (K,3) f32, conf (K,) f32,
    valid (K,) bool, overflowed () bool)."""
    uniq, sums, count, conf, valid, overflowed, _ = cc_label_and_extract(
        prob, threshold, max_components, max_candidates, sweeps_per_check,
        pointer_jump,
    )
    centroids = sums / jnp.maximum(count, 1.0)[:, None]
    return centroids, conf, valid, overflowed


def components_from_candidates(
    flat_idx: np.ndarray, prob: np.ndarray, shape
) -> Tbars:
    """Exact 6-connectivity CC from the sparse set of above-threshold
    voxels (ascending unique flat indices into a ``shape`` volume).

    Semantically identical to ``scipy.ndimage.label`` + centroid/max-conf
    extraction on the dense mask (the host reference): connectivity is
    evaluated on the candidate set itself, which IS the thresholded mask.
    Built for the sparse masks synapse detection produces (~0.01-1%
    occupancy): work scales with candidate count, not volume size —
    neighbor lookups are searchsorted into the sorted index list and the
    components come from one ``scipy.sparse.csgraph`` pass.  Used by the
    streaming detection path (infer/large.py cc_impl="sparse"), where
    each ROI ships only its compacted core candidates.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components as _cc

    a = np.asarray(flat_idx, np.int64)
    p = np.asarray(prob, np.float64)
    n = a.shape[0]
    if n == 0:
        return Tbars(locs=np.zeros((0, 3)), conf=np.zeros((0,)))
    vz, vy, vx = shape
    x = a % vx
    y = (a // vx) % vy
    z = a // (vy * vx)
    ri, ci = [], []
    for delta, guard in (
        (1, x != vx - 1),
        (vx, y != vy - 1),
        (vy * vx, z != vz - 1),
    ):
        b = a + delta
        pos = np.searchsorted(a, b)
        ok = guard & (pos < n)
        ok[ok] = a[pos[ok]] == b[ok]
        ri.append(np.nonzero(ok)[0])
        ci.append(pos[ok])
    ri = np.concatenate(ri + [np.arange(n)])
    ci = np.concatenate(ci + [np.arange(n)])
    g = sp.coo_matrix(
        (np.ones(ri.shape[0], np.int8), (ri, ci)), shape=(n, n)
    )
    ncomp, lab = _cc(g, directed=False)
    count = np.bincount(lab, minlength=ncomp).astype(np.float64)
    cents = np.stack(
        [
            np.bincount(lab, weights=c, minlength=ncomp) / count
            for c in (z, y, x)
        ],
        axis=1,
    )
    conf = np.full(ncomp, -np.inf)
    np.maximum.at(conf, lab, p)
    return sort_detections(cents, conf)


class SeamUnionFind:
    """Union-find over (block_key, slot) nodes for cross-block CC merging."""

    def __init__(self):
        self.parent: dict = {}

    def find(self, a):
        p = self.parent
        root = a
        while p.setdefault(root, root) != root:
            root = p[root]
        while p[a] != root:  # path compression
            p[a], a = root, p[a]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def merge_component_fragments(blocks: dict, sentinel: int) -> Tbars:
    """Merge per-block CC fragments into whole-volume components.

    ``blocks`` maps a 3-D grid key ``(iz, iy, ix)`` to a dict with:

    - ``uniq`` (K,) ascending local root ids (padded with huge values),
    - ``sums`` (K, 3) GLOBAL coordinate sums, ``count`` (K,), ``conf`` (K,),
      ``valid`` (K,) — from :func:`cc_label_and_extract`, sums globalized
      by the block's corner;
    - ``faces``: 6 boundary label planes in the order (z-lo, z-hi, y-lo,
      y-hi, x-lo, x-hi), values = local root ids or ``sentinel``
      (the block voxel count) where below threshold.

    Components whose boundary voxels are 6-adjacent across a block seam
    are unioned (exactly ``scipy.ndimage.label``'s connectivity — corner
    contact never links under 6-connectivity, so face adjacency is
    complete), then counts/coordinate-sums/max-conf reduce per root, so
    centroids and confidences equal a monolithic run's.  Shared by the
    mesh-sharded path (parallel.halo.sharded_components) and the
    out-of-core streaming path (infer.large.detect_streaming).
    """
    uf = SeamUnionFind()

    # face index pairs: (axis, this-block hi face, neighbor lo face)
    face_pairs = [(0, 1, 0), (1, 3, 2), (2, 5, 4)]
    for (iz, iy, ix), data in blocks.items():
        for axis, hi_f, lo_f in face_pairs:
            nb = (iz + (axis == 0), iy + (axis == 1), ix + (axis == 2))
            if nb not in blocks:
                continue
            a = data["faces"][hi_f]
            b = blocks[nb]["faces"][lo_f]
            pair = (a < sentinel) & (b < sentinel)
            if not pair.any():
                continue
            ka = np.searchsorted(data["uniq"], a[pair])
            kb = np.searchsorted(blocks[nb]["uniq"], b[pair])
            for sa, sb in set(zip(ka.tolist(), kb.tolist())):
                uf.union(((iz, iy, ix), sa), (nb, sb))

    roots: dict = {}
    for key, data in blocks.items():
        for slot in np.nonzero(data["valid"])[0]:
            r = uf.find((key, int(slot)))
            acc = roots.setdefault(r, [0.0, np.zeros(3), -np.inf])
            acc[0] += data["count"][slot]
            acc[1] = acc[1] + data["sums"][slot]
            acc[2] = max(acc[2], float(data["conf"][slot]))

    if not roots:
        return Tbars(locs=np.zeros((0, 3)), conf=np.zeros((0,)))
    locs = np.stack([v[1] / v[0] for v in roots.values()])
    confs = np.asarray([v[2] for v in roots.values()])
    return sort_detections(locs, confs)


def label_components(
    prob, threshold: float = 0.5, max_components: int = 1024
) -> Tbars:
    """Public CC verb: probability volume -> centroid detection list.

    Device-computed; grows ``max_components`` and retries on overflow so no
    component is silently dropped.
    """
    prob = jnp.asarray(prob)
    centroids, conf, valid, overflowed = components_device(
        prob, threshold=float(threshold), max_components=max_components
    )
    if bool(overflowed):
        return label_components(prob, threshold, max_components * 4)
    valid = np.asarray(valid)
    return sort_detections(
        np.asarray(centroids)[valid], np.asarray(conf)[valid]
    )
