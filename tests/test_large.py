"""Out-of-core streaming detection == monolithic, bit-for-bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flypylib_tpu.infer.large import (
    array_reader,
    detect_h5,
    detect_streaming,
)
from flypylib_tpu.io.hdf5 import write_h5
from flypylib_tpu.models.zoo import baseline_model
from flypylib_tpu.ops.host_reference import components_host, nms_host
from tests.test_detect_ops import assert_same_detections
from tests.test_pipeline import reference_prob


@pytest.fixture(scope="module")
def model():
    spec = baseline_model(features=(4, 6), dilations=(1, 2),
                          head_features=8, dtype=jnp.float32)
    variables = spec.init(jax.random.PRNGKey(0), 16)
    leaves, treedef = jax.tree.flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    variables = jax.tree.unflatten(
        treedef,
        [0.5 * jax.random.normal(k, l.shape, l.dtype)
         for k, l in zip(keys, leaves)],
    )
    return spec, variables


def test_streaming_equals_monolithic(model, rng):
    spec, variables = model
    vol = rng.random((64, 48, 56)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.995))
    host = nms_host(prob, window=3, threshold=thr)
    shape, read = array_reader(vol)
    got = detect_streaming(
        spec, variables, shape, read, core=32, tile_out=32,
        window=3, threshold=thr, max_detections_per_roi=1024,
    )
    assert len(host) > 0
    assert_same_detections(host, got)


def test_streaming_nondivisible_cores(model, rng):
    spec, variables = model
    vol = rng.random((50, 41, 47)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.99))
    host = nms_host(prob, window=5, threshold=thr)
    shape, read = array_reader(vol)
    got = detect_streaming(
        spec, variables, shape, read, core=24, tile_out=24,
        window=5, threshold=thr, max_detections_per_roi=2048,
    )
    assert_same_detections(host, got)


@pytest.mark.parametrize("cc_impl", ["sparse", "device"])
def test_streaming_components_seam_merge(model, rng, cc_impl):
    """Chunked CC == monolithic scipy label on non-divisible cores
    (components span ROI seams), for BOTH backends: sparse host-csgraph
    over shipped candidates and device label-sweeps + union-find."""
    spec, variables = model
    vol = rng.random((50, 41, 47)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.97))  # large, seam-spanning blobs
    host = components_host(prob, threshold=thr)
    assert len(host) > 0
    shape, read = array_reader(vol)
    got = detect_streaming(
        spec, variables, shape, read, core=24, tile_out=24,
        threshold=thr, method="components",
        max_components_per_roi=4096, cc_impl=cc_impl,
    )
    assert_same_detections(host, got, loc_tol=1e-3)


def test_streaming_components_overflow_grows(model, rng):
    """Tiny per-ROI component budget self-heals via grow-and-retry."""
    spec, variables = model
    vol = rng.random((40, 33, 37)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.9))  # many components
    host = components_host(prob, threshold=thr)
    shape, read = array_reader(vol)
    got = detect_streaming(
        spec, variables, shape, read, core=20, tile_out=20,
        threshold=thr, method="components",
        max_components_per_roi=4, cc_impl="device",
    )
    assert_same_detections(host, got, loc_tol=1e-3)


def test_streaming_sparse_cc_candidate_overflow_grows(model, rng):
    """The sparse backend's candidate budget also self-heals."""
    from flypylib_tpu.infer.large import make_stream_plan

    spec, variables = model
    vol = rng.random((40, 33, 37)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.9))  # many candidates
    host = components_host(prob, threshold=thr)
    shape, read = array_reader(vol)
    plan = make_stream_plan(
        spec, variables, shape, core=20, tile_out=20,
        threshold=thr, method="components", cc_impl="sparse",
    )
    plan.C = 16  # force per-ROI candidate overflow
    got = detect_streaming(
        spec, variables, shape, read, core=20, tile_out=20,
        threshold=thr, method="components", plan=plan,
    )
    assert plan.C > 16  # grew
    assert_same_detections(host, got, loc_tol=1e-3)


@pytest.mark.parametrize(
    "cc_impl,fused_impl",
    [("sparse", "nbr"), ("sparse", "filter"), ("device", None)],
)
def test_streaming_both_methods(model, rng, cc_impl, fused_impl):
    """method="both" vs host reference, for both fused postprocess
    implementations (sparse neighborhood-gather is_max vs dense max
    filter) and the device-CC backend."""
    from flypylib_tpu.infer.large import make_stream_plan

    spec, variables = model
    vol = rng.random((40, 40, 40)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.99))
    shape, read = array_reader(vol)
    plan = make_stream_plan(
        spec, variables, shape, core=24, tile_out=24,
        window=3, threshold=thr, method="both", cc_impl=cc_impl,
        fused_impl=fused_impl or "filter",
    )
    nms_det, cc_det = detect_streaming(
        spec, variables, shape, read, core=24, tile_out=24,
        window=3, threshold=thr, method="both", cc_impl=cc_impl, plan=plan,
    )
    assert_same_detections(nms_host(prob, window=3, threshold=thr), nms_det)
    assert_same_detections(
        components_host(prob, threshold=thr), cc_det, loc_tol=1e-3
    )


def test_streaming_both_fused_overflow_grows(model, rng):
    """method="both" + sparse runs the FUSED single-dispatch postprocess
    (one core compaction yields both lists); its candidate budget must
    self-heal like the separate paths', keeping BOTH the NMS and the CC
    list complete."""
    from flypylib_tpu.infer.large import make_stream_plan

    spec, variables = model
    vol = rng.random((40, 33, 37)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.9))  # many candidates
    shape, read = array_reader(vol)
    plan = make_stream_plan(
        spec, variables, shape, core=20, tile_out=20, window=3,
        threshold=thr, method="both", cc_impl="sparse",
    )
    plan.C = 16  # force per-ROI candidate overflow in the fused post
    nms_det, cc_det = detect_streaming(
        spec, variables, shape, read, core=20, tile_out=20, window=3,
        threshold=thr, method="both", plan=plan,
    )
    assert plan.C > 16  # grew
    assert_same_detections(nms_host(prob, window=3, threshold=thr), nms_det)
    assert_same_detections(
        components_host(prob, threshold=thr), cc_det, loc_tol=1e-3
    )


def test_detect_h5_roundtrip(model, rng, tmp_path):
    spec, variables = model
    vol = rng.random((48, 48, 48)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.995))
    path = str(tmp_path / "vol.h5")
    write_h5(path, vol)
    got = detect_h5(
        spec, variables, path, core=32, tile_out=32, window=3,
        threshold=thr, max_detections_per_roi=1024,
    )
    host = nms_host(prob, window=3, threshold=thr)
    assert_same_detections(host, got)


def test_staged_equals_streaming_and_monolithic(model, rng):
    """detect_staged (HBM-resident, device-sliced ROIs) == detect_streaming
    == host reference, including seam ownership and non-divisible cores."""
    from flypylib_tpu.infer.large import detect_staged

    spec, variables = model
    vol = rng.random((45, 38, 41)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.995))
    host_nms = nms_host(prob, window=5, threshold=thr)
    host_cc = components_host(prob, threshold=thr)
    shape, read = array_reader(vol)
    stream = detect_streaming(
        spec, variables, shape, read, core=20, window=5, threshold=thr,
        method="both",
    )
    staged = detect_staged(
        spec, variables, vol, core=20, window=5, threshold=thr,
        method="both", forward="roi",  # pin the per-ROI-forward path
    )
    assert len(host_nms) > 0 and len(host_cc) > 0
    for h, s, g in zip((host_nms, host_cc), stream, staged):
        assert_same_detections(h, s)
        assert len(s) == len(g)
        np.testing.assert_array_equal(s.locs, g.locs)
        np.testing.assert_array_equal(s.conf, g.conf)


def test_staged_uint8_and_reuse(model, rng):
    """uint8 volumes stay uint8 on the wire; a staged upload is reusable
    across calls (threshold sweeps)."""
    from flypylib_tpu.infer.large import (
        detect_staged,
        make_stream_plan,
        stage_volume,
    )

    spec, variables = model
    vol = (rng.random((40, 33, 37)) * 255).astype(np.uint8)
    # the device path scales uint8 by multiplying with (1/255): divide on
    # the host reference flips ULPs and near-threshold candidates with it
    prob = reference_prob(
        spec, variables, vol.astype(np.float32) * np.float32(1.0 / 255.0)
    )
    thr = float(np.quantile(prob, 0.99))
    host = nms_host(prob, window=5, threshold=thr)
    plan = make_stream_plan(
        spec, variables, vol.shape, core=24, window=5, threshold=thr
    )
    staged = stage_volume(vol, plan=plan)
    assert staged[0].dtype == np.uint8  # 4x cheaper on the wire
    got1 = detect_staged(
        spec, variables, vol, core=24, window=5, threshold=thr,
        staged=staged, forward="roi",
    )
    got2 = detect_staged(
        spec, variables, vol, core=24, window=5,
        threshold=float(np.quantile(prob, 0.999)), staged=staged,
        forward="roi",
    )
    assert len(host) > 0
    assert_same_detections(host, got1)
    assert 0 < len(got2) < len(got1)


def test_streaming_device_cc_face_overflow_grows(model, rng):
    """The device backend's sparse-face slot budget (F) self-heals via
    its own grow-and-retry flag, independent of K."""
    from flypylib_tpu.infer.large import make_stream_plan

    spec, variables = model
    vol = rng.random((40, 33, 37)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.9))  # dense faces
    host = components_host(prob, threshold=thr)
    shape, read = array_reader(vol)
    plan = make_stream_plan(
        spec, variables, shape, core=20, tile_out=20,
        threshold=thr, method="components", cc_impl="device",
        max_components_per_roi=4096,
    )
    plan.F = 2  # force per-face overflow without K overflow
    got = detect_streaming(
        spec, variables, shape, read, core=20, tile_out=20,
        threshold=thr, method="components", cc_impl="device", plan=plan,
    )
    assert plan.F > 2  # grew
    assert plan.K == 4096  # K untouched by a face-only overflow
    assert_same_detections(host, got, loc_tol=1e-3)


def test_default_tile_total_under_cap(model):
    """_default_tile never returns a monolithic >cap tile: prime-ish
    extents with no valid divisor fall back to an overshooting grid with
    the largest valid tile <= cap (a monolithic 283^3 ROI tile OOMs via
    XLA conv-patch materialization)."""
    from flypylib_tpu.infer.large import _default_tile

    spec, _ = model
    for extent in (283, 277, 331, 401):  # primes > cap
        d = _default_tile(extent, spec)
        assert d <= 176, (extent, d)
        assert d % max(spec.size_multiple, 1) == 0
        assert spec.is_valid_size(d + 2 * spec.context)


def test_streaming_overshoot_tiles(model, rng):
    """A non-dividing tile_out (overshooting tile grid) stays exact —
    the fallback _default_tile relies on this."""
    spec, variables = model
    vol = rng.random((41, 37, 43)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.99))
    host = nms_host(prob, window=5, threshold=thr)
    shape, read = array_reader(vol)
    got = detect_streaming(
        spec, variables, shape, read, core=23, tile_out=20,  # 33 % 20 != 0
        window=5, threshold=thr, max_detections_per_roi=2048,
    )
    assert len(host) > 0
    assert_same_detections(host, got)


def test_check_plan_rejects_mismatched_args(model, rng):
    """A plan silently overriding the caller's core/tile args raises."""
    from flypylib_tpu.infer.large import make_stream_plan

    spec, variables = model
    vol = rng.random((40, 33, 37)).astype(np.float32)
    shape, read = array_reader(vol)
    plan = make_stream_plan(
        spec, variables, shape, core=20, tile_out=20, threshold=0.5,
    )
    with pytest.raises(ValueError, match="core"):
        detect_streaming(spec, variables, shape, read, core=32, plan=plan)
    with pytest.raises(ValueError, match="tile_out"):
        detect_streaming(
            spec, variables, shape, read, tile_out=24, plan=plan
        )
    # omitted args (None) defer to the plan: no error
    got = detect_streaming(spec, variables, shape, read, plan=plan)
    prob = reference_prob(spec, variables, vol)
    host = nms_host(prob, window=5, threshold=0.5)
    assert_same_detections(host, got)


def test_stage_volume_requires_plan_or_halo(rng):
    from flypylib_tpu.infer.large import stage_volume

    with pytest.raises(ValueError, match="plan or .*halo|halo"):
        stage_volume(rng.random((8, 8, 8)).astype(np.float32))


def test_stage_volume_device_pad_bitwise(rng):
    """stage_volume uploads the raw volume and reflect-pads on device —
    bitwise np.pad(mode="reflect"), for uint8 and f32, including the
    host fallback when an extent is too small to reflect."""
    from flypylib_tpu.infer.large import stage_volume

    for dtype in (np.uint8, np.float32):
        vol = rng.random((20, 17, 23)).astype(np.float32)
        if dtype == np.uint8:
            vol = (vol * 255).astype(np.uint8)
        big, h = stage_volume(vol, halo=7)
        assert h == 7
        np.testing.assert_array_equal(
            np.asarray(big), np.pad(vol, [(7, 7)] * 3, mode="reflect")
        )
    tiny = rng.random((5, 12, 12)).astype(np.float32)
    big, h = stage_volume(tiny, halo=7)  # 5 <= 7: host np.pad fallback
    np.testing.assert_array_equal(
        np.asarray(big), np.pad(tiny, [(7, 7)] * 3, mode="reflect")
    )


@pytest.mark.parametrize("chunk", [8, 64])
def test_staged_chunked_bit_identical(model, rng, chunk):
    """detect_staged over chunk-staged volumes (raw z-chunks, windows
    assembled on device) == the monolithic staged sweep, bit-identical —
    including anisotropic cores, uint8, and chunk sizes that do or don't
    divide the volume."""
    from flypylib_tpu.infer.large import (
        detect_staged,
        make_stream_plan,
        stage_volume,
        stage_volume_chunked,
    )

    spec, variables = model
    for shape, core, dtype in [
        ((40, 33, 37), 16, np.float32),
        ((30, 20, 20), (12, 20, 10), np.float32),
        ((40, 33, 37), 16, np.uint8),
    ]:
        vol = rng.random(shape).astype(np.float32)
        if dtype == np.uint8:
            vol = (vol * 255).astype(np.uint8)
        common = dict(window=3, threshold=0.55, method="both",
                      forward="roi")  # pin the per-ROI chunked path
        plan = make_stream_plan(
            spec, variables, shape, core=core,
            **{k: v for k, v in common.items() if k != "forward"},
        )
        mono = detect_staged(spec, variables, vol,
                             staged=stage_volume(vol, plan=plan),
                             plan=plan, **common)
        staged = stage_volume_chunked(vol, plan=plan, chunk=chunk)
        ch = detect_staged(spec, variables, vol, staged=staged,
                           plan=plan, **common)
        for a, b in zip(mono, ch):
            assert len(a) == len(b)
            np.testing.assert_array_equal(a.locs, b.locs)
            np.testing.assert_array_equal(a.conf, b.conf)


def test_staged_chunked_window_vs_monolithic(model, rng):
    """_StagedChunks.window(start, size) == the monolithic big's slice
    for every ROI of a plan — the invariant the chunked sweep rests on
    (also crosses two different chunkings to catch assembly-executable
    cache collisions)."""
    from flypylib_tpu.infer.large import (
        make_stream_plan,
        stage_volume,
        stage_volume_chunked,
    )

    spec, variables = model
    shape = (40, 26, 30)
    vol = rng.random(shape).astype(np.float32)
    plan = make_stream_plan(spec, variables, shape, core=16, window=3,
                            threshold=0.5, method="nms")
    big, h = stage_volume(vol, plan=plan)
    big = np.asarray(big)
    P = plan.pipe.padded_shape
    ext = [max(0, max(c[d] for _, c in plan.grid) + P[d] - big.shape[d])
           for d in range(3)]
    big = np.pad(big, [(0, e) for e in ext])
    for chunk in (7, 16):
        staged = stage_volume_chunked(vol, plan=plan, chunk=chunk)
        for _, corner in plan.grid:
            w = np.asarray(staged.window(tuple(corner), P))
            ref = big[
                corner[0] : corner[0] + P[0],
                corner[1] : corner[1] + P[1],
                corner[2] : corner[2] + P[2],
            ]
            np.testing.assert_array_equal(w, ref, err_msg=str(corner))


def test_staged_multi_device_bit_identical(model, rng):
    """detect_staged(devices=...) fans the ROI sweep over local devices
    with bit-identical detections (disjoint cores, order-exact merge)."""
    from flypylib_tpu.infer.large import detect_staged

    spec, variables = model
    vol = rng.random((40, 33, 37)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.99))
    single = detect_staged(
        spec, variables, vol, core=20, window=5, threshold=thr,
        method="both",
    )
    multi = detect_staged(
        spec, variables, vol, core=20, window=5, threshold=thr,
        method="both", devices=jax.devices()[:4],
    )
    for s, m in zip(single, multi):
        np.testing.assert_array_equal(s.locs, m.locs)
        np.testing.assert_array_equal(s.conf, m.conf)
    host = nms_host(prob, window=5, threshold=thr)
    assert len(host) > 0
    assert_same_detections(host, multi[0])


def test_streaming_anisotropic_core(model, rng):
    """core=(z, y, x) triples partition exactly like cubic cores."""
    spec, variables = model
    vol = rng.random((50, 41, 47)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.99))
    host = nms_host(prob, window=5, threshold=thr)
    shape, read = array_reader(vol)
    got = detect_streaming(
        spec, variables, shape, read, core=(48, 24, 16), tile_out=24,
        window=5, threshold=thr, max_detections_per_roi=2048,
    )
    assert len(host) > 0
    assert_same_detections(host, got)


@pytest.mark.parametrize(
    "method,cc_impl",
    [("both", "sparse"), ("both", "device"), ("nms", "sparse"),
     ("components", "sparse"), ("components", "device")],
)
def test_staged_shared_forward_bit_identical(model, rng, method, cc_impl):
    """forward="shared" (one whole-volume forward + windowed postprocess
    over the -inf shell) == forward="roi" bit-identically, for every
    method/backend combination — on a non-divisible shape and core, so
    core boxes overhang the volume and the shell's out-of-volume -inf
    rule is load-bearing."""
    from flypylib_tpu.infer.large import detect_staged, make_stream_plan

    spec, variables = model
    vol = rng.random((45, 38, 41)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.985))
    common = dict(core=20, window=5, threshold=thr, method=method,
                  cc_impl=cc_impl)
    plan = make_stream_plan(spec, variables, vol.shape, **common)
    roi = detect_staged(spec, variables, vol, plan=plan, **common)
    shared = detect_staged(spec, variables, vol, plan=plan,
                           forward="shared", **common)
    pairs = zip(roi, shared) if method == "both" else [(roi, shared)]
    for a, b in pairs:
        assert len(a) > 0
        np.testing.assert_array_equal(a.locs, b.locs)
        np.testing.assert_array_equal(a.conf, b.conf)
    # and both match the host reference
    if method in ("nms", "both"):
        host = nms_host(prob, window=5, threshold=thr)
        assert_same_detections(
            host, shared[0] if method == "both" else shared
        )
    if method in ("components", "both"):
        host = components_host(prob, threshold=thr)
        assert_same_detections(
            host, shared[1] if method == "both" else shared,
            loc_tol=1e-3,
        )


def test_staged_shared_forward_chunked_and_uint8(model, rng):
    """Shared mode over a chunk-staged uint8 volume (device-assembled
    slab windows) == the roi sweep, bit-identically."""
    from flypylib_tpu.infer.large import (
        detect_staged,
        make_stream_plan,
        stage_volume_chunked,
    )

    spec, variables = model
    vol = (rng.random((40, 33, 37)) * 255).astype(np.uint8)
    prob = reference_prob(
        spec, variables, vol.astype(np.float32) * np.float32(1.0 / 255.0)
    )
    thr = float(np.quantile(prob, 0.99))
    common = dict(core=16, window=3, threshold=thr, method="both")
    plan = make_stream_plan(spec, variables, vol.shape, **common)
    roi = detect_staged(spec, variables, vol, plan=plan, **common)
    staged = stage_volume_chunked(vol, plan=plan, chunk=13)
    shared = detect_staged(spec, variables, vol, plan=plan,
                           staged=staged, forward="shared", **common)
    for a, b in zip(roi, shared):
        assert len(a) > 0
        np.testing.assert_array_equal(a.locs, b.locs)
        np.testing.assert_array_equal(a.conf, b.conf)


def test_staged_shared_forward_overflow_grows(model, rng):
    """Shared-mode slot budgets (fused C, NMS K) self-heal via
    grow-and-retry against the held shell."""
    from flypylib_tpu.infer.large import detect_staged, make_stream_plan

    spec, variables = model
    vol = rng.random((40, 33, 37)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.9))  # many candidates
    common = dict(core=20, window=3, threshold=thr, method="both")
    plan = make_stream_plan(spec, variables, vol.shape, **common)
    plan.C = 16
    host = nms_host(prob, window=3, threshold=thr)
    got = detect_staged(spec, variables, vol, plan=plan,
                        forward="shared", **common)
    assert plan.C > 16  # grew
    assert_same_detections(host, got[0])

    common = dict(core=20, window=3, threshold=thr, method="nms")
    plan = make_stream_plan(spec, variables, vol.shape,
                            max_detections_per_roi=4, **common)
    got = detect_staged(spec, variables, vol, plan=plan,
                        forward="shared", **common)
    assert plan._nms_K > 4  # grew
    assert_same_detections(host, got)


def test_shared_boxes_coarsen_mixed(model, rng):
    """The shared-mode postprocess partition coarsens base cores into
    ~target-extent boxes (forward cost is core-independent there, so
    fewer/larger postprocess windows are strictly cheaper).  Force
    MIXED box shapes (a
    remainder group per axis) and pin shared == roi == host."""
    from flypylib_tpu.infer.large import detect_staged, make_stream_plan

    spec, variables = model
    vol = rng.random((43, 37, 26)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.97))
    common = dict(core=8, window=3, threshold=thr, method="both")
    plan = make_stream_plan(spec, variables, vol.shape, **common)
    plan.shared_box_target = 16  # 2x2x2 cores per box + remainders
    boxes = plan._shared_boxes()
    assert len(boxes) < len(plan.grid)
    assert len({dims for _, _, dims in boxes}) > 1  # mixed shapes
    # boxes tile the base grid's coverage exactly
    ext = [
        max(c[d] for _, c in plan.grid) + plan.core_dims[d]
        for d in range(3)
    ]
    covered = np.zeros(ext, np.int32)
    for _, c, dims in boxes:
        covered[c[0]:c[0] + dims[0], c[1]:c[1] + dims[1],
                c[2]:c[2] + dims[2]] += 1
    assert covered.min() == covered.max() == 1
    roi = detect_staged(spec, variables, vol, plan=plan, **common)
    shared = detect_staged(spec, variables, vol, plan=plan,
                           forward="shared", **common)
    for a, b in zip(roi, shared):
        assert len(a) > 0
        np.testing.assert_array_equal(a.locs, b.locs)
        np.testing.assert_array_equal(a.conf, b.conf)
    host = nms_host(prob, window=3, threshold=thr)
    assert_same_detections(host, shared[0])


def test_staged_shared_forward_pooled(rng):
    """Shared mode with a pooling (U-Net) spec: the whole-volume grid
    keeps the monolithic pooling phase, detections == roi mode == host."""
    import jax

    from flypylib_tpu.infer.large import detect_staged, make_stream_plan
    from flypylib_tpu.models.zoo import unet

    spec = unet(base_features=2, levels=1, convs_per_stage=1)
    variables = spec.init(jax.random.PRNGKey(0))
    vol = rng.random((36, 30, 34)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.99))
    common = dict(core=24, window=3, threshold=thr, method="nms")
    plan = make_stream_plan(spec, variables, vol.shape, **common)
    roi = detect_staged(spec, variables, vol, plan=plan, **common)
    shared = detect_staged(spec, variables, vol, plan=plan,
                           forward="shared", **common)
    assert len(roi) > 0
    np.testing.assert_array_equal(roi.locs, shared.locs)
    np.testing.assert_array_equal(roi.conf, shared.conf)
    assert_same_detections(nms_host(prob, window=3, threshold=thr), shared)


def test_staged_forward_mode_validation(model, rng):
    """forward= is validated; auto picks shared for small volumes (and
    stays exact)."""
    from flypylib_tpu.infer.large import detect_staged, make_stream_plan

    spec, variables = model
    vol = rng.random((40, 33, 37)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.99))
    with pytest.raises(ValueError, match="forward mode"):
        detect_staged(spec, variables, vol, threshold=thr,
                      forward="nope")
    common = dict(core=20, window=5, threshold=thr, method="nms")
    plan = make_stream_plan(spec, variables, vol.shape, **common)
    assert plan.shared_auto(vol.nbytes)  # tiny volume: shared fits
    got = detect_staged(spec, variables, vol, plan=plan,
                        forward="auto", **common)
    assert_same_detections(nms_host(prob, window=5, threshold=thr), got)


@pytest.mark.parametrize("n_dev", [2, 3, 8])
def test_staged_shared_forward_multi_device(model, rng, n_dev):
    """forward="shared" with devices=: z-band partitioned shells, one
    per device — detections bit-identical to the single-device shared
    sweep AND the roi sweep, on a non-divisible shape where bands
    overlap (shifted last band) and core boxes overhang the volume.
    n_dev=8 exceeds the row count, exercising the band clamp."""
    from flypylib_tpu.infer.large import detect_staged, make_stream_plan

    spec, variables = model
    vol = rng.random((45, 30, 33)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.985))
    common = dict(core=16, window=5, threshold=thr, method="both")
    plan = make_stream_plan(spec, variables, vol.shape, **common)
    single = detect_staged(spec, variables, vol, plan=plan,
                           forward="shared", **common)
    multi = detect_staged(spec, variables, vol, plan=plan,
                          forward="shared",
                          devices=jax.devices()[:n_dev], **common)
    roi = detect_staged(spec, variables, vol, plan=plan,
                        forward="roi", **common)
    for a, b, c in zip(single, multi, roi):
        assert len(a) > 0
        np.testing.assert_array_equal(a.locs, b.locs)
        np.testing.assert_array_equal(a.conf, b.conf)
        np.testing.assert_array_equal(a.locs, c.locs)
        np.testing.assert_array_equal(a.conf, c.conf)
    host = nms_host(prob, window=5, threshold=thr)
    assert_same_detections(host, multi[0])


def test_staged_shared_multi_device_pooled(rng):
    """Multi-device shared mode with a pooling (U-Net) spec: band grids
    keep the monolithic pooling phase (band_z0 - h == 0 mod
    size_multiple), detections == single-device shared == host."""
    import jax as _jax

    from flypylib_tpu.infer.large import detect_staged, make_stream_plan
    from flypylib_tpu.models.zoo import unet

    spec = unet(base_features=2, levels=1, convs_per_stage=1)
    variables = spec.init(_jax.random.PRNGKey(0))
    vol = rng.random((52, 30, 34)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.99))
    common = dict(core=16, window=3, threshold=thr, method="nms")
    plan = make_stream_plan(spec, variables, vol.shape, **common)
    single = detect_staged(spec, variables, vol, plan=plan,
                           forward="shared", **common)
    multi = detect_staged(spec, variables, vol, plan=plan,
                          forward="shared",
                          devices=_jax.devices()[:3], **common)
    assert len(single) > 0
    np.testing.assert_array_equal(single.locs, multi.locs)
    np.testing.assert_array_equal(single.conf, multi.conf)
    assert_same_detections(nms_host(prob, window=3, threshold=thr), multi)


def test_staged_shared_anisotropic_core_and_edges(model, rng):
    """Shared mode on geometry edges: anisotropic (z, y, x) core with an
    anisotropic window; core >= volume (single-ROI grid, where the
    multi-device band fan-out degenerates to one band); window wider
    than a core axis.  All == roi mode / host, bit-identically."""
    from flypylib_tpu.infer.large import detect_staged, make_stream_plan

    spec, variables = model
    vol = rng.random((42, 31, 36)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)

    # anisotropic core + window
    thr = float(np.quantile(prob, 0.985))
    common = dict(core=(24, 12, 16), window=(3, 5, 3), threshold=thr,
                  method="both")
    plan = make_stream_plan(spec, variables, vol.shape, **common)
    roi = detect_staged(spec, variables, vol, plan=plan,
                        forward="roi", **common)
    shared = detect_staged(spec, variables, vol, plan=plan,
                           forward="shared", **common)
    multi = detect_staged(spec, variables, vol, plan=plan,
                          forward="shared", devices=jax.devices()[:2],
                          **common)
    for a, b, c in zip(roi, shared, multi):
        assert len(a) > 0
        np.testing.assert_array_equal(a.locs, b.locs)
        np.testing.assert_array_equal(a.conf, b.conf)
        np.testing.assert_array_equal(a.locs, c.locs)
        np.testing.assert_array_equal(a.conf, c.conf)

    # core >= volume: one ROI; devices= degenerates to one band
    common = dict(core=64, window=3, threshold=thr, method="nms")
    plan = make_stream_plan(spec, variables, vol.shape, **common)
    assert len(plan.grid) == 1
    roi = detect_staged(spec, variables, vol, plan=plan,
                        forward="roi", **common)
    multi = detect_staged(spec, variables, vol, plan=plan,
                          forward="shared", devices=jax.devices()[:4],
                          **common)
    assert len(roi) > 0
    np.testing.assert_array_equal(roi.locs, multi.locs)
    np.testing.assert_array_equal(roi.conf, multi.conf)
    assert_same_detections(nms_host(prob, window=3, threshold=thr), multi)

    # window wider than the core axis (halo > core)
    common = dict(core=8, window=9, threshold=thr, method="nms")
    plan = make_stream_plan(spec, variables, vol.shape, **common)
    roi = detect_staged(spec, variables, vol, plan=plan,
                        forward="roi", **common)
    shared = detect_staged(spec, variables, vol, plan=plan,
                           forward="shared", **common)
    np.testing.assert_array_equal(roi.locs, shared.locs)
    np.testing.assert_array_equal(roi.conf, shared.conf)
    assert_same_detections(nms_host(prob, window=9, threshold=thr), shared)


def test_staged_shared_multi_device_chunked_uint8(model, rng):
    """Multi-device shared mode from a chunk-staged uint8 upload
    (assembled to the monolithic form for band slicing) == roi mode."""
    from flypylib_tpu.infer.large import (
        detect_staged,
        make_stream_plan,
        stage_volume_chunked,
    )

    spec, variables = model
    vol = (rng.random((48, 30, 33)) * 255).astype(np.uint8)
    prob = reference_prob(
        spec, variables, vol.astype(np.float32) * np.float32(1.0 / 255.0)
    )
    thr = float(np.quantile(prob, 0.99))
    common = dict(core=16, window=3, threshold=thr, method="both")
    plan = make_stream_plan(spec, variables, vol.shape, **common)
    roi = detect_staged(spec, variables, vol, plan=plan,
                        forward="roi", **common)
    staged = stage_volume_chunked(vol, plan=plan, chunk=17)
    multi = detect_staged(spec, variables, vol, plan=plan,
                          staged=staged, forward="shared",
                          devices=jax.devices()[:2], **common)
    for a, b in zip(roi, multi):
        assert len(a) > 0
        np.testing.assert_array_equal(a.locs, b.locs)
        np.testing.assert_array_equal(a.conf, b.conf)


def test_pooled_default_core_and_tile(rng):
    """Pooling topologies get covering-tile streaming defaults: the
    largest core whose ONE covering tile input stays under the
    428 tile-input cap, and detections stay
    exactly the host reference's."""
    import jax

    from flypylib_tpu.infer.large import (
        _default_core,
        array_reader,
        make_stream_plan,
    )
    from flypylib_tpu.models.zoo import unet
    from flypylib_tpu.ops.packed_unet import packed_unet_spec

    spec = unet(base_features=2, levels=1, convs_per_stage=1)
    pspec = packed_unet_spec(spec) or spec
    core = _default_core(pspec, 5, 256)
    h = pspec.context + 2
    tin = pspec.valid_size(core + 2 * h + 2 * pspec.context)
    assert tin <= 428 and core >= 256

    # a small volume through the pooled defaults: ONE covering tile per
    # ROI (the plain U-Net spec is pooled too, and keeps the host
    # reference bit-comparable)
    variables = spec.init(jax.random.PRNGKey(0))
    vol = rng.random((36, 36, 36)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.99))
    plan = make_stream_plan(
        spec, variables, vol.shape, core=24, window=3, threshold=thr,
    )
    roi_extent = max(plan.core_dims) + 2 * plan.h
    assert plan.pipe._tiled.tile_out >= roi_extent  # covering tile
    assert plan.pipe._tiled.tile_batch == 1
    shape, read = array_reader(vol)
    got = detect_streaming(
        spec, variables, shape, read, window=3, threshold=thr, plan=plan,
    )
    assert_same_detections(nms_host(prob, window=3, threshold=thr), got)

    # HBM-resident path through the same pooled plan
    from flypylib_tpu.infer.large import detect_staged

    got2 = detect_staged(
        spec, variables, vol, window=3, threshold=thr, plan=plan,
    )
    assert_same_detections(got, got2)


@pytest.mark.parametrize(
    "method,cc_impl",
    [("nms", "sparse"), ("both", "sparse"), ("components", "device")],
)
def test_streaming_shared_bit_identical(model, rng, method, cc_impl):
    """Out-of-core shared forward (detect_streaming forward="shared")
    == the roi sweep bit-identically, for every method/backend combo,
    on a non-divisible shape (core boxes overhang the volume)."""
    from flypylib_tpu.infer.large import make_stream_plan

    spec, variables = model
    vol = rng.random((45, 38, 41)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.985))
    common = dict(core=20, window=5, threshold=thr, method=method,
                  cc_impl=cc_impl)
    shape, read = array_reader(vol)
    plan = make_stream_plan(spec, variables, shape, **common)
    roi = detect_streaming(spec, variables, shape, read, plan=plan,
                           forward="roi", **common)
    shared = detect_streaming(spec, variables, shape, read, plan=plan,
                              forward="shared", **common)
    pairs = zip(roi, shared) if method == "both" else [(roi, shared)]
    for a, b in pairs:
        assert len(a) > 0
        np.testing.assert_array_equal(a.locs, b.locs)
        np.testing.assert_array_equal(a.conf, b.conf)
    if method in ("nms", "both"):
        host = nms_host(prob, window=5, threshold=thr)
        assert_same_detections(
            host, shared[0] if method == "both" else shared
        )
    if method in ("components", "both"):
        host = components_host(prob, threshold=thr)
        assert_same_detections(
            host, shared[1] if method == "both" else shared,
            loc_tol=1e-3,
        )


def test_streaming_shared_multi_band(model, rng):
    """Forced one-row bands (band_rpb=1): per-band windows with reflect
    halos + band-local shells still reproduce the roi sweep and the
    host reference bitwise — the z-seam semantics of the band split."""
    from flypylib_tpu.infer.large import make_stream_plan

    spec, variables = model
    vol = rng.random((58, 38, 41)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.985))
    common = dict(core=20, window=3, threshold=thr, method="both")
    shape, read = array_reader(vol)
    plan = make_stream_plan(spec, variables, shape, **common)
    assert len({c[0] for _, c in plan.grid}) >= 3  # several z rows
    plan.band_rpb = lambda **kw: 1  # force one band per z row
    roi = detect_streaming(spec, variables, shape, read, plan=plan,
                           forward="roi", **common)
    shared = detect_streaming(spec, variables, shape, read, plan=plan,
                              forward="shared", **common)
    for a, b in zip(roi, shared):
        assert len(a) > 0
        np.testing.assert_array_equal(a.locs, b.locs)
        np.testing.assert_array_equal(a.conf, b.conf)
    assert_same_detections(nms_host(prob, window=3, threshold=thr),
                           shared[0])


@pytest.mark.parametrize("rpb", [None, 1])
def test_streaming_shared_pooled(rng, rpb):
    """Pooled (U-Net) specs through the out-of-core shared forward:
    ConvTranspose parity reach makes in-volume probs near a face read
    the full fetch_halo reflect band — the band window must reflect
    fetch_halo (not ctx) past the true faces, then zero-extend
    (regression pin for the band-window padding rule)."""
    import jax

    from flypylib_tpu.infer.large import make_stream_plan
    from flypylib_tpu.models.zoo import unet

    spec = unet(base_features=2, levels=1, convs_per_stage=1)
    variables = spec.init(jax.random.PRNGKey(0))
    # even extents: the pooled module's monolithic output (the host
    # reference) drops the last plane on odd extents, so only even
    # shapes are host-comparable; cores still overhang (48 > 42/46)
    vol = rng.random((52, 42, 46)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.99))
    common = dict(core=24, window=3, threshold=thr, method="nms")
    shape, read = array_reader(vol)
    plan = make_stream_plan(spec, variables, shape, **common)
    if rpb is not None:
        plan.band_rpb = lambda **kw: rpb
    roi = detect_streaming(spec, variables, shape, read, plan=plan,
                           forward="roi", **common)
    shared = detect_streaming(spec, variables, shape, read, plan=plan,
                              forward="shared", **common)
    assert len(roi) > 0
    np.testing.assert_array_equal(roi.locs, shared.locs)
    np.testing.assert_array_equal(roi.conf, shared.conf)
    assert_same_detections(nms_host(prob, window=3, threshold=thr),
                           shared)


def test_streaming_shared_uint8_reader(model, rng):
    """uint8 readers ride the shared band path (uint8 wire windows,
    device cast) and match the roi sweep bitwise."""
    from flypylib_tpu.infer.large import make_stream_plan

    spec, variables = model
    vol = (rng.random((45, 38, 41)) * 255).astype(np.uint8)
    shape, read = array_reader(vol)
    prob = reference_prob(
        spec, variables, vol.astype(np.float32) * np.float32(1.0 / 255.0)
    )
    thr = float(np.quantile(prob, 0.99))
    common = dict(core=20, window=3, threshold=thr, method="nms")
    plan = make_stream_plan(spec, variables, shape, **common)
    roi = detect_streaming(spec, variables, shape, read, plan=plan,
                           forward="roi", **common)
    shared = detect_streaming(spec, variables, shape, read, plan=plan,
                              forward="shared", **common)
    assert len(roi) > 0
    np.testing.assert_array_equal(roi.locs, shared.locs)
    np.testing.assert_array_equal(roi.conf, shared.conf)


def test_streaming_forward_mode_validation(model, rng):
    """forward= is validated; volumes at/below the fetch halo refuse
    forward="shared" with guidance (and auto falls back to roi)."""
    spec, variables = model
    vol = rng.random((8, 8, 8)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.9))
    shape, read = array_reader(vol)
    with pytest.raises(ValueError, match="forward mode"):
        detect_streaming(spec, variables, shape, read, core=8,
                         threshold=thr, forward="nope")
    # default window=5 makes fetch_halo 8 == min(shape): band windows
    # can't single-reflect, so forward="shared" must refuse with guidance
    with pytest.raises(ValueError, match="forward='roi'"):
        detect_streaming(spec, variables, shape, read, core=8,
                         threshold=thr, forward="shared")
    got = detect_streaming(spec, variables, shape, read, core=8, window=3,
                           threshold=thr, forward="auto")
    assert_same_detections(nms_host(prob, window=3, threshold=thr), got)


@pytest.mark.parametrize("n_dev", [2, 3])
def test_streaming_multi_device(model, rng, n_dev):
    """detect_streaming(devices=): roi mode round-robins per-ROI
    forwards, shared mode round-robins z-bands — both bit-identical to
    the single-device sweep on a non-divisible shape."""
    from flypylib_tpu.infer.large import make_stream_plan

    spec, variables = model
    vol = rng.random((45, 30, 33)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.985))
    common = dict(core=16, window=5, threshold=thr, method="both")
    shape, read = array_reader(vol)
    plan = make_stream_plan(spec, variables, shape, **common)
    single = detect_streaming(spec, variables, shape, read, plan=plan,
                              forward="roi", **common)
    roi_multi = detect_streaming(spec, variables, shape, read, plan=plan,
                                 forward="roi",
                                 devices=jax.devices()[:n_dev], **common)
    sh_multi = detect_streaming(spec, variables, shape, read, plan=plan,
                                forward="shared",
                                devices=jax.devices()[:n_dev], **common)
    for a, b, c in zip(single, roi_multi, sh_multi):
        assert len(a) > 0
        np.testing.assert_array_equal(a.locs, b.locs)
        np.testing.assert_array_equal(a.conf, b.conf)
        np.testing.assert_array_equal(a.locs, c.locs)
        np.testing.assert_array_equal(a.conf, c.conf)
    host = nms_host(prob, window=5, threshold=thr)
    assert_same_detections(host, sh_multi[0])


def test_streaming_multi_device_pooled(rng):
    """Multi-device out-of-core shared bands with a pooling spec: band
    anchors keep the monolithic pooling phase and the band windows'
    fetch_halo reflect rule holds on every device."""
    import jax as _jax

    from flypylib_tpu.infer.large import make_stream_plan
    from flypylib_tpu.models.zoo import unet

    spec = unet(base_features=2, levels=1, convs_per_stage=1)
    variables = spec.init(_jax.random.PRNGKey(0))
    vol = rng.random((52, 42, 46)).astype(np.float32)
    prob = reference_prob(spec, variables, vol)
    thr = float(np.quantile(prob, 0.99))
    common = dict(core=24, window=3, threshold=thr, method="nms")
    shape, read = array_reader(vol)
    plan = make_stream_plan(spec, variables, shape, **common)
    single = detect_streaming(spec, variables, shape, read, plan=plan,
                              forward="roi", **common)
    multi = detect_streaming(spec, variables, shape, read, plan=plan,
                             forward="shared",
                             devices=_jax.devices()[:2], **common)
    assert len(single) > 0
    np.testing.assert_array_equal(single.locs, multi.locs)
    np.testing.assert_array_equal(single.conf, multi.conf)
    assert_same_detections(nms_host(prob, window=3, threshold=thr), multi)


def test_stream_plan_explicit_tile_flows_to_shared_pipe(model, rng):
    """make_stream_plan(tile_out=, tile_batch=) governs the SHARED
    whole-volume forward too (not only the per-ROI pipe), and
    detections stay identical to the policy default even when the
    explicit tile does not divide the volume (grid-extension masking is
    exact)."""
    from flypylib_tpu.infer.large import (
        detect_staged,
        make_stream_plan,
        stage_volume_chunked,
    )

    spec, variables = model
    shape = (40, 40, 40)
    vol = (rng.random(shape) * 255).astype(np.uint8)
    common = dict(window=3, threshold=0.55, max_detections_per_roi=512,
                  max_components_per_roi=512, method="both")

    plan_dflt = make_stream_plan(spec, variables, shape, core=20, **common)
    plan_t14 = make_stream_plan(spec, variables, shape, core=20,
                                tile_out=14, tile_batch=2, **common)
    assert plan_t14.full_pipe()._tiled.tile_out == 14
    assert plan_t14.full_pipe()._tiled.tile_batch == 2
    assert plan_dflt.full_pipe()._tiled.tile_out != 14

    staged_d = stage_volume_chunked(vol, plan=plan_dflt)
    staged_t = stage_volume_chunked(vol, plan=plan_t14)
    det_d = detect_staged(spec, variables, vol, staged=staged_d,
                          plan=plan_dflt, forward="shared", **common)
    det_t = detect_staged(spec, variables, vol, staged=staged_t,
                          plan=plan_t14, forward="shared", **common)
    for a, b in zip(det_d, det_t):
        np.testing.assert_array_equal(a.locs, b.locs)
