"""Multi-chip logic on the virtual 8-device CPU mesh (SURVEY.md section 4
item 4): sharded inference == monolithic, seam-correct sharded NMS,
data-parallel training step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flypylib_tpu.models.zoo import baseline_model
from flypylib_tpu.ops.host_reference import nms_host
from flypylib_tpu.parallel import (
    make_dp_train_step,
    make_mesh,
    sharded_infer,
    sharded_nms,
)
from flypylib_tpu.train.trainer import TrainConfig, Trainer
from tests.conftest import make_blob_volume


@pytest.fixture(scope="module")
def small_model():
    spec = baseline_model(features=(4, 6), dilations=(1, 2), head_features=8,
                          dtype=jnp.float32)
    variables = spec.init(jax.random.PRNGKey(0), 16)
    return spec, variables


def monolithic(spec, variables, vol):
    c = spec.context
    padded = np.pad(vol, c, mode="reflect")
    x = jnp.asarray(padded[None, ..., None], dtype=jnp.float32)
    logits = spec.module.apply(variables, x, train=False)
    return np.asarray(jax.nn.sigmoid(logits[0, ..., 0]))


def test_sharded_infer_equals_monolithic(small_model, rng):
    spec, variables = small_model
    mesh = make_mesh(4, axis="space")
    vol = rng.random((32, 20, 20)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    shard = np.asarray(sharded_infer(spec, variables, vol, mesh))
    np.testing.assert_array_equal(shard, mono)


def test_sharded_infer_nondivisible_z(small_model, rng):
    spec, variables = small_model
    mesh = make_mesh(4, axis="space")
    vol = rng.random((30, 16, 16)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    shard = np.asarray(sharded_infer(spec, variables, vol, mesh))
    np.testing.assert_array_equal(shard, mono)


def test_sharded_nms_seams(rng):
    """Peaks placed exactly at shard boundaries must not duplicate/vanish."""
    mesh = make_mesh(4, axis="space")
    vol = np.zeros((32, 16, 16), dtype=np.float32)
    # slab size 8: isolated peaks at/adjacent to seams (different y/x so
    # none suppresses another), plus one that IS suppressed across a seam
    for z, y, x, v in [
        (7, 4, 4, 0.9), (8, 8, 8, 0.8), (15, 12, 12, 0.95),
        (16, 4, 12, 0.7), (24, 12, 4, 0.85),
        (23, 12, 4, 0.84),  # adjacent to the 0.85 peak -> suppressed
    ]:
        vol[z, y, x] = v
    host = nms_host(vol, window=3, threshold=0.5)
    dev = sharded_nms(vol, mesh, window=3, threshold=0.5, max_per_shard=16)
    assert len(host) == 5
    np.testing.assert_array_equal(host.locs, dev.locs)
    np.testing.assert_allclose(host.conf, dev.conf, rtol=1e-6)


def test_sharded_nms_plateau_across_seam():
    mesh = make_mesh(4, axis="space")
    vol = np.zeros((32, 16, 16), dtype=np.float32)
    vol[7:10, 8, 8] = 0.9  # plateau spanning the z=8 seam
    host = nms_host(vol, window=3, threshold=0.5)
    dev = sharded_nms(vol, mesh, window=3, threshold=0.5, max_per_shard=16)
    assert len(host) == len(dev) == 3
    np.testing.assert_array_equal(host.locs, dev.locs)


def test_sharded_nms_random(rng):
    mesh = make_mesh(8, axis="space")
    vol = rng.random((40, 24, 24)).astype(np.float32)
    host = nms_host(vol, window=3, threshold=0.85)
    dev = sharded_nms(vol, mesh, window=3, threshold=0.85,
                      max_per_shard=256)
    assert len(host) > 0
    np.testing.assert_array_equal(host.locs, dev.locs)
    np.testing.assert_allclose(host.conf, dev.conf, rtol=1e-6)


def test_dp_train_step_matches_single_chip():
    """Same seed => DP-sharded step produces the same params as single."""
    from flypylib_tpu.train.trainer import TrainData, make_train_step

    spec = baseline_model(features=(4,), dilations=(1,), head_features=8,
                          dtype=jnp.float32)
    cfg = TrainConfig(patch_size=9, batch_size=8, augment=True)
    rng = np.random.default_rng(0)
    image = rng.random((24, 24, 24)).astype(np.float32)
    labels = (rng.random((24, 24, 24)) > 0.9).astype(np.float32)
    mask = np.ones((24, 24, 24), np.float32)
    data = TrainData.build(image, labels, mask, spec.valid_size(9))

    tr = Trainer(spec, cfg, seed=0)
    state0 = tr.init_state()
    key = jax.random.PRNGKey(3)

    single_step, _, _ = make_train_step(spec, cfg)
    s1, m1 = single_step(state0, key, data)

    mesh = make_mesh(4, axis="data")
    dp_step, _, _ = make_dp_train_step(spec, cfg, mesh)
    s2, m2 = dp_step(state0, key, data)

    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(s1.params),
                    jax.tree_util.tree_leaves(s2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_dp_train_step_loss_decreases():
    from flypylib_tpu.train.trainer import TrainData

    spec = baseline_model(features=(4,), dilations=(1,), head_features=8,
                          dtype=jnp.float32)
    cfg = TrainConfig(patch_size=9, batch_size=16, learning_rate=3e-3)
    mesh = make_mesh(8, axis="data")
    rng = np.random.default_rng(1)
    image = rng.random((24, 24, 24)).astype(np.float32)
    labels = (image > 0.8).astype(np.float32)
    mask = np.ones((24, 24, 24), np.float32)
    data = TrainData.build(image, labels, mask, spec.valid_size(9))

    tr = Trainer(spec, cfg, seed=0)
    state = tr.init_state()
    dp_step, _, _ = make_dp_train_step(spec, cfg, mesh)
    key = jax.random.PRNGKey(0)
    losses = []
    for i in range(30):
        key, k = jax.random.split(key)
        state, m = dp_step(state, k, data)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_dp_multi_volume():
    """DP step over a list of differently-shaped labeled volumes."""
    from flypylib_tpu.train.trainer import TrainData

    spec = baseline_model(features=(4,), dilations=(1,), head_features=8,
                          dtype=jnp.float32)
    cfg = TrainConfig(patch_size=9, batch_size=8)
    mesh = make_mesh(4, axis="data")
    rng = np.random.default_rng(2)
    images = [rng.random((20, 20, 20)).astype(np.float32),
              rng.random((24, 16, 28)).astype(np.float32)]
    labels = [(im > 0.9).astype(np.float32) for im in images]
    masks = [np.ones_like(im) for im in images]
    data = TrainData.build(images, labels, masks, spec.valid_size(9))

    tr = Trainer(spec, cfg, seed=0)
    state = tr.init_state()
    dp_step, _, _ = make_dp_train_step(spec, cfg, mesh)
    state, m = dp_step(state, jax.random.PRNGKey(0), data)
    assert np.isfinite(float(m["loss"]))


def test_sharded_infer_tiled_z(small_model, rng):
    """Bounded-memory per-shard z-tiling matches monolithic bitwise."""
    spec, variables = small_model
    mesh = make_mesh(4, axis="space")
    vol = rng.random((32, 18, 18)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    for tz in (2, 4, 8):
        shard = np.asarray(
            sharded_infer(spec, variables, vol, mesh, tile_z=tz)
        )
        np.testing.assert_array_equal(shard, mono)


def test_sharded_infer_tile_z_validation(small_model):
    spec, variables = small_model
    mesh = make_mesh(4, axis="space")
    vol = np.zeros((32, 16, 16), np.float32)
    with pytest.raises(ValueError, match="divide"):
        sharded_infer(spec, variables, vol, mesh, tile_z=3)


def test_sharded_components_seam_merge(rng):
    """Components spanning shard seams merge exactly (centroid + conf)."""
    from flypylib_tpu.ops.host_reference import components_host
    from flypylib_tpu.parallel.halo import sharded_components
    from tests.test_detect_ops import assert_same_detections

    mesh = make_mesh(4, axis="space")
    vol = np.zeros((32, 16, 16), dtype=np.float32)
    vol[6:11, 8, 8] = [0.6, 0.7, 0.9, 0.7, 0.6]  # spans the z=8 seam
    vol[14:18, 4, 4] = 0.8  # spans the z=16 seam
    vol[20, 12, 12] = 0.75  # interior singleton
    vol[7, 3, 3] = 0.65  # another interior
    host = components_host(vol, threshold=0.5)
    dev = sharded_components(vol, mesh, threshold=0.5, max_components=16)
    assert len(host) == 4
    assert_same_detections(host, dev, loc_tol=1e-4)


def test_sharded_components_random(rng):
    from flypylib_tpu.ops.host_reference import components_host
    from flypylib_tpu.parallel.halo import sharded_components
    from tests.test_detect_ops import assert_same_detections

    mesh = make_mesh(8, axis="space")
    vol = (rng.random((40, 12, 12)) > 0.8).astype(np.float32)
    host = components_host(vol, threshold=0.5)
    dev = sharded_components(vol, mesh, threshold=0.5, max_components=512)
    assert len(host) > 10
    assert_same_detections(host, dev, loc_tol=1e-3)


def test_sharded_components_component_through_many_shards(rng):
    """One component threading through all 4 shards (multi-seam chain)."""
    from flypylib_tpu.ops.host_reference import components_host
    from flypylib_tpu.parallel.halo import sharded_components
    from tests.test_detect_ops import assert_same_detections

    mesh = make_mesh(4, axis="space")
    vol = np.zeros((32, 8, 8), dtype=np.float32)
    vol[:, 4, 4] = 0.9  # a 32-voxel column through every shard
    host = components_host(vol, threshold=0.5)
    dev = sharded_components(vol, mesh, threshold=0.5, max_components=8)
    assert len(host) == 1
    assert_same_detections(host, dev, loc_tol=1e-4)


def test_sharded_nms_default_max_per_shard_small_volume(rng):
    """Default max_per_shard larger than the slab no longer crashes."""
    mesh = make_mesh(8, axis="space")
    vol = rng.random((16, 16, 16)).astype(np.float32)  # slab 512 < 1024
    host = nms_host(vol, window=3, threshold=0.9)
    dev = sharded_nms(vol, mesh, window=3, threshold=0.9)
    np.testing.assert_array_equal(host.locs, dev.locs)


# ---------------------------------------------------------------------------
# 2-D (z x y) spatial sharding
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh2d():
    from flypylib_tpu.parallel import make_mesh_2d

    return make_mesh_2d((4, 2), axes=("spacez", "spacey"))


def test_sharded_infer_2d_equals_monolithic(small_model, mesh2d, rng):
    spec, variables = small_model
    vol = rng.random((24, 20, 18)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    shard = np.asarray(
        sharded_infer(spec, variables, vol, mesh2d,
                      axis=("spacez", "spacey"))
    )
    np.testing.assert_array_equal(shard, mono)


def test_sharded_infer_2d_nondivisible(small_model, mesh2d, rng):
    """Non-divisible extents + corner-dependent voxels stay bitwise."""
    spec, variables = small_model
    vol = rng.random((27, 15, 14)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    shard = np.asarray(
        sharded_infer(spec, variables, vol, mesh2d,
                      axis=("spacez", "spacey"))
    )
    np.testing.assert_array_equal(shard, mono)


def test_sharded_infer_thin_volume_totality(small_model, rng):
    """Volumes thinner than n_shards*context no longer refuse (the shard
    grid extends past the volume; extension is cropped)."""
    spec, variables = small_model  # context 3
    mesh = make_mesh(8, axis="space")
    vol = rng.random((8, 16, 16)).astype(np.float32)  # slab would be 1 < 3
    mono = monolithic(spec, variables, vol)
    shard = np.asarray(sharded_infer(spec, variables, vol, mesh))
    np.testing.assert_array_equal(shard, mono)


def test_sharded_infer_2d_tiled_z(small_model, mesh2d, rng):
    spec, variables = small_model
    vol = rng.random((24, 20, 18)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    shard = np.asarray(
        sharded_infer(spec, variables, vol, mesh2d,
                      axis=("spacez", "spacey"), tile_z=3)
    )
    np.testing.assert_array_equal(shard, mono)


def test_sharded_nms_2d_seams(mesh2d):
    """Peaks at z-seams, y-seams, and the seam crossing point."""
    vol = np.zeros((24, 20, 16), dtype=np.float32)
    # z-extent 6 per shard, y-extent 10 per shard
    for z, y, x, v in [
        (5, 4, 4, 0.9), (6, 14, 8, 0.8),     # z seam, both sides
        (12, 9, 4, 0.95), (12, 10, 12, 0.7),  # y seam, both sides
        (17, 9, 8, 0.85), (18, 10, 8, 0.84),  # diagonal across both seams
    ]:
        vol[z, y, x] = v
    host = nms_host(vol, window=3, threshold=0.5)
    dev = sharded_nms(vol, mesh2d, axis=("spacez", "spacey"),
                      window=3, threshold=0.5, max_per_shard=16)
    np.testing.assert_array_equal(host.locs, dev.locs)
    np.testing.assert_allclose(host.conf, dev.conf, rtol=1e-6)


def test_sharded_nms_2d_random(mesh2d, rng):
    vol = rng.random((25, 21, 17)).astype(np.float32)
    host = nms_host(vol, window=5, threshold=0.85)
    dev = sharded_nms(vol, mesh2d, axis=("spacez", "spacey"),
                      window=5, threshold=0.85, max_per_shard=256)
    assert len(host) > 0
    np.testing.assert_array_equal(host.locs, dev.locs)
    np.testing.assert_allclose(host.conf, dev.conf, rtol=1e-6)


def test_sharded_components_2d(mesh2d, rng):
    from flypylib_tpu.ops.host_reference import components_host
    from flypylib_tpu.parallel.halo import sharded_components
    from tests.test_detect_ops import assert_same_detections

    vol = np.zeros((24, 20, 16), dtype=np.float32)
    vol[4:8, 8:12, 8] = 0.8     # spans the y seam and a z seam
    vol[11:14, 5, 5] = 0.9      # spans a z seam only
    vol[12, 9, 3] = 0.6         # corner-adjacent pair across the seam
    vol[13, 10, 4] = 0.7        # (diagonal: must stay TWO components)
    host = components_host(vol, threshold=0.5)
    dev = sharded_components(vol, mesh2d, axis=("spacez", "spacey"),
                             threshold=0.5, max_components=16)
    assert_same_detections(host, dev, loc_tol=1e-4)


def test_sharded_components_2d_random(mesh2d, rng):
    from flypylib_tpu.ops.host_reference import components_host
    from flypylib_tpu.parallel.halo import sharded_components
    from tests.test_detect_ops import assert_same_detections

    vol = (rng.random((25, 19, 14)) > 0.75).astype(np.float32)
    host = components_host(vol, threshold=0.5)
    dev = sharded_components(vol, mesh2d, axis=("spacez", "spacey"),
                             threshold=0.5, max_components=1024)
    assert len(host) > 10
    assert_same_detections(host, dev, loc_tol=1e-3)


def test_sharded_infer_2d_packed_spec(rng):
    """2-D sharding composes with the packed engine (size_multiple=2)."""
    from flypylib_tpu.ops.packed_conv import packed_spec
    from flypylib_tpu.parallel import make_mesh_2d

    spec = baseline_model(features=(4, 6), dilations=(1, 2),
                          head_features=8, dtype=jnp.float32)
    pspec = packed_spec(spec)
    variables = spec.init(jax.random.PRNGKey(0), 16)
    mesh = make_mesh_2d((2, 2), axes=("spacez", "spacey"))
    vol = rng.random((20, 18, 16)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    shard = np.asarray(
        sharded_infer(pspec, variables, vol, mesh,
                      axis=("spacez", "spacey"))
    )
    np.testing.assert_allclose(shard, mono, rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def mesh3d():
    from flypylib_tpu.parallel import make_mesh_3d

    return make_mesh_3d((2, 2, 2))


AX3 = ("spacez", "spacey", "spacex")


def test_sharded_infer_3d_equals_monolithic(small_model, mesh3d, rng):
    spec, variables = small_model
    vol = rng.random((20, 18, 16)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    shard = np.asarray(
        sharded_infer(spec, variables, vol, mesh3d, axis=AX3)
    )
    np.testing.assert_array_equal(shard, mono)


def test_sharded_infer_3d_nondivisible(small_model, mesh3d, rng):
    """Non-divisible extents + 3-D-corner-dependent voxels stay bitwise
    (corner data rides the three-hop z->y->x exchange)."""
    spec, variables = small_model
    vol = rng.random((21, 15, 13)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    shard = np.asarray(
        sharded_infer(spec, variables, vol, mesh3d, axis=AX3)
    )
    np.testing.assert_array_equal(shard, mono)


def test_sharded_nms_3d_seams(mesh3d):
    """Peaks at z-, y-, and x-seams, plus the triple seam corner."""
    vol = np.zeros((16, 16, 16), dtype=np.float32)
    for z, y, x, v in [
        (7, 4, 4, 0.9), (8, 12, 4, 0.8),     # z seam, both sides
        (4, 7, 4, 0.95), (4, 8, 12, 0.7),    # y seam, both sides
        (4, 12, 7, 0.85), (12, 4, 8, 0.84),  # x seam, both sides
        (7, 8, 7, 0.99), (8, 7, 8, 0.98),    # around the triple corner
    ]:
        vol[z, y, x] = v
    host = nms_host(vol, window=3, threshold=0.5)
    dev = sharded_nms(vol, mesh3d, axis=AX3, window=3, threshold=0.5,
                      max_per_shard=16)
    np.testing.assert_array_equal(host.locs, dev.locs)
    np.testing.assert_allclose(host.conf, dev.conf, rtol=1e-6)


def test_sharded_nms_3d_random(mesh3d, rng):
    vol = rng.random((19, 17, 15)).astype(np.float32)
    host = nms_host(vol, window=5, threshold=0.85)
    dev = sharded_nms(vol, mesh3d, axis=AX3, window=5, threshold=0.85,
                      max_per_shard=256)
    assert len(host) > 0
    np.testing.assert_array_equal(host.locs, dev.locs)
    np.testing.assert_allclose(host.conf, dev.conf, rtol=1e-6)


def test_sharded_components_3d(mesh3d):
    from flypylib_tpu.ops.host_reference import components_host
    from flypylib_tpu.parallel.halo import sharded_components
    from tests.test_detect_ops import assert_same_detections

    vol = np.zeros((16, 16, 16), dtype=np.float32)
    vol[6:10, 8, 8] = 0.8       # spans the z seam
    vol[8, 6:10, 3] = 0.9       # spans the y seam
    vol[3, 8, 6:10] = 0.7       # spans the x seam
    vol[6:10, 6:10, 6:10] = 0.6  # blob through the triple corner
    vol[7, 7, 3] = 0.5          # diagonal pair across the x seam:
    vol[8, 8, 4] = 0.55         # must stay TWO components (6-conn)
    host = components_host(vol, threshold=0.45)
    dev = sharded_components(vol, mesh3d, axis=AX3, threshold=0.45,
                             max_components=64)
    assert_same_detections(host, dev, loc_tol=1e-4)


def test_sharded_components_3d_random(mesh3d, rng):
    from flypylib_tpu.ops.host_reference import components_host
    from flypylib_tpu.parallel.halo import sharded_components
    from tests.test_detect_ops import assert_same_detections

    vol = (rng.random((19, 17, 14)) > 0.75).astype(np.float32)
    host = components_host(vol, threshold=0.5)
    dev = sharded_components(vol, mesh3d, axis=AX3, threshold=0.5,
                             max_components=1024)
    assert len(host) > 10
    assert_same_detections(host, dev, loc_tol=1e-3)


def test_sharded_infer_3d_packed_spec(mesh3d, rng):
    """3-D sharding composes with the packed engine (size_multiple=2)."""
    from flypylib_tpu.ops.packed_conv import packed_spec

    spec = baseline_model(features=(4, 6), dilations=(1, 2),
                          head_features=8, dtype=jnp.float32)
    pspec = packed_spec(spec)
    variables = spec.init(jax.random.PRNGKey(0), 16)
    vol = rng.random((20, 18, 16)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    shard = np.asarray(
        sharded_infer(pspec, variables, vol, mesh3d, axis=AX3)
    )
    np.testing.assert_allclose(shard, mono, rtol=2e-4, atol=2e-4)


def test_sharded_infer_tile_out_batched(small_model, rng):
    """Per-shard batched small-cube tile sweep (the fast conv regime)
    == monolithic, bitwise — 1-D mesh."""
    spec, variables = small_model
    mesh = make_mesh(4, axis="space")
    vol = rng.random((32, 20, 20)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    shard = np.asarray(
        sharded_infer(spec, variables, vol, mesh, tile_out=8,
                      tile_batch=4)
    )
    np.testing.assert_array_equal(shard, mono)


def test_sharded_infer_tile_out_2d_nondivisible(small_model, mesh2d, rng):
    """tile_out sweep with grid overshoot inside shards, 2-D mesh,
    non-divisible volume — still bitwise monolithic."""
    spec, variables = small_model
    vol = rng.random((30, 22, 17)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    shard = np.asarray(
        sharded_infer(spec, variables, vol, mesh2d,
                      axis=("spacez", "spacey"), tile_out=12,
                      tile_batch=3)
    )
    np.testing.assert_array_equal(shard, mono)


def test_sharded_infer_tile_out_packed_spec(rng):
    """tile_out sweep composes with the packed engine (size_multiple=2):
    aligned tile starts keep packing phase — equal to plain monolithic."""
    from flypylib_tpu.ops.packed_conv import packed_spec
    from flypylib_tpu.parallel import make_mesh_2d

    spec = baseline_model(features=(4, 6), dilations=(1, 2),
                          head_features=8, dtype=jnp.float32)
    pspec = packed_spec(spec)
    variables = spec.init(jax.random.PRNGKey(0), 16)
    mesh = make_mesh_2d((2, 2), axes=("spacez", "spacey"))
    vol = rng.random((20, 18, 16)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    shard = np.asarray(
        sharded_infer(pspec, variables, vol, mesh,
                      axis=("spacez", "spacey"), tile_out=8,
                      tile_batch=4)
    )
    np.testing.assert_allclose(shard, mono, rtol=2e-4, atol=2e-4)


def test_sharded_infer_tile_out_validation(small_model):
    spec, variables = small_model
    from flypylib_tpu.ops.packed_conv import packed_spec

    mesh = make_mesh(4, axis="space")
    vol = np.zeros((32, 16, 16), np.float32)
    with pytest.raises(ValueError, match="not both"):
        sharded_infer(spec, variables, vol, mesh, tile_z=8, tile_out=8)
    base = baseline_model(features=(4,), dilations=(1,), head_features=8,
                          dtype=jnp.float32)
    ps = packed_spec(base)
    pvars = base.init(jax.random.PRNGKey(0), 16)
    with pytest.raises(ValueError, match="multiple"):
        sharded_infer(ps, pvars, vol, mesh, tile_out=7)


def test_sharded_infer_uint8_wire(small_model, rng, monkeypatch):
    """uint8 volumes stay uint8 through host staging and the halo
    exchange (4x less wire/RAM), cast in-graph — bitwise equal to the
    monolithic uint8 path."""
    import flypylib_tpu.parallel.halo as halo_mod

    spec, variables = small_model
    mesh = make_mesh(4, axis="space")
    vol8 = (rng.random((32, 20, 20)) * 255).astype(np.uint8)
    mono = monolithic(spec, variables, vol8.astype(np.float32))

    staged_dtypes = []
    real_asarray = halo_mod.jnp.asarray

    def spy(a, *k, **kw):
        if isinstance(a, np.ndarray):  # host staging only, not tracers
            staged_dtypes.append(a.dtype)
        return real_asarray(a, *k, **kw)

    monkeypatch.setattr(halo_mod.jnp, "asarray", spy)
    shard = np.asarray(sharded_infer(spec, variables, vol8, mesh))
    np.testing.assert_array_equal(shard, mono)
    # the staging copies (work + z pads) crossed as uint8; no f32 copy
    # was ever materialized on host (int32 = tile-corner indices)
    assert np.uint8 in staged_dtypes
    assert not any(d in (np.float32, np.float64) for d in staged_dtypes)
