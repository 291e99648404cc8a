"""Tiled inference == monolithic inference, bitwise (SURVEY.md section 4
item 3 — the stitching guardrail)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flypylib_tpu.infer.tiled import TiledInference
from flypylib_tpu.models.zoo import baseline_model, unet


def monolithic(spec, variables, vol):
    """Reference: pad whole volume by context, single forward pass."""
    c = spec.context
    padded = np.pad(vol, c, mode="reflect")
    x = jnp.asarray(padded[None, ..., None], dtype=jnp.float32)
    logits = spec.module.apply(variables, x, train=False)
    return np.asarray(jax.nn.sigmoid(logits[0, ..., 0]))


@pytest.fixture(scope="module")
def small_model():
    spec = baseline_model(features=(4, 6), dilations=(1, 2),
                          head_features=8, dtype=jnp.float32)
    variables = spec.init(jax.random.PRNGKey(0), 16)
    return spec, variables


def test_tiled_equals_monolithic_exact(small_model, rng):
    spec, variables = small_model
    vol = rng.random((40, 40, 40)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    for tile_out, batch in [(16, 1), (16, 4), (24, 2)]:
        eng = TiledInference(spec, variables, tile_out=tile_out,
                             tile_batch=batch)
        tiled = eng.infer(vol)
        assert tiled.shape == vol.shape
        np.testing.assert_array_equal(tiled, mono)


def test_tiled_nondivisible_shapes(small_model, rng):
    spec, variables = small_model
    vol = rng.random((37, 29, 41)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    eng = TiledInference(spec, variables, tile_out=16, tile_batch=3)
    np.testing.assert_array_equal(eng.infer(vol), mono)


def test_tiled_volume_smaller_than_tile(small_model, rng):
    spec, variables = small_model
    vol = rng.random((12, 12, 12)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    eng = TiledInference(spec, variables, tile_out=32)
    np.testing.assert_array_equal(eng.infer(vol), mono)


def test_tiled_keep_on_device(small_model, rng):
    spec, variables = small_model
    vol = rng.random((20, 20, 20)).astype(np.float32)
    eng = TiledInference(spec, variables, tile_out=16)
    out = eng.infer(vol, keep_on_device=True)
    assert isinstance(out, jax.Array)
    np.testing.assert_array_equal(np.asarray(out), eng.infer(vol))


def test_tiled_unet(rng):
    spec = unet(base_features=4, levels=1, convs_per_stage=1,
                dtype=jnp.float32)
    s = spec.valid_size(24)
    variables = spec.init(jax.random.PRNGKey(0), s)
    vol = rng.random((30, 30, 30)).astype(np.float32)
    mono = monolithic(spec, variables, vol)
    eng = TiledInference(spec, variables, tile_out=12)
    np.testing.assert_array_equal(eng.infer(vol), mono)


def test_host_stream_equals_device_path(small_model, rng):
    """The double-buffered host-feed path (for volumes too big to hold
    padded input + output in HBM) matches the single-dispatch path."""
    spec, variables = small_model
    vol = rng.random((30, 25, 33)).astype(np.float32)
    eng = TiledInference(spec, variables, tile_out=16, tile_batch=2)
    on_dev = eng.infer(vol)
    streamed = eng.infer(vol, host_stream=True)
    np.testing.assert_array_equal(on_dev, streamed)


def test_default_tiling_regimes():
    """Model-aware defaults: covering tile for pooling topologies,
    batched 64-wide grid for conv stacks; metadata override wins;
    large pooled volumes fall back to the largest tile under the cap."""
    import dataclasses

    from flypylib_tpu.infer.tiled import default_tiling
    from flypylib_tpu.ops.packed_conv import packed_spec
    from flypylib_tpu.ops.packed_unet import packed_unet_spec

    u = unet()
    pu = packed_unet_spec(u)
    for s in (u, pu):
        tout, tb = default_tiling(s, (192, 192, 192))
        assert (tout, tb) == (192, 1)
        # the snapped tile input covers the volume and is under the cap
        tin = s.valid_size(tout + 2 * s.context)
        assert tin - 2 * s.context >= 192 and tin <= 428

    b = baseline_model()
    pb = packed_spec(b)
    for s in (b, pb):
        tout, tb = default_tiling(s, (192, 192, 192))
        assert (tout, tb) == (64, 8)
    # grid batch is bounded by the tile count for small volumes
    assert default_tiling(pb, (64, 64, 64)) == (64, 1)
    assert default_tiling(pb, (64, 64, 130)) == (64, 3)

    # pooled volume past the cap: largest valid tile input <= 428
    tout, tb = default_tiling(pu, (512, 512, 512))
    assert tb == 1
    tin = pu.valid_size(tout + 2 * pu.context)
    assert tin <= 428 and tout >= 300

    # explicit metadata override beats the topology heuristic
    forced = dataclasses.replace(
        pb, metadata={**pb.metadata, "tiling": "cover"}
    )
    assert default_tiling(forced, (96, 96, 96)) == (96, 1)


def test_network_default_tiling_matches_explicit(rng):
    """FplNetwork.infer with model-aware defaults == explicit tiling
    (bitwise — tiled == monolithic invariant)."""
    from flypylib_tpu.network import FplNetwork

    net = FplNetwork("baseline", features=(4, 4), dilations=(1, 1))
    vol = rng.random((40, 40, 40)).astype(np.float32)
    a = net.infer(vol)
    b = net.infer(vol, tile_out=24, tile_batch=2)
    np.testing.assert_array_equal(a, b)


def test_infer_uint8_wire_bitwise(rng):
    """uint8 volumes ride the wire as uint8 and cast on device — results
    bitwise equal to the host-side f32 cast (0..255 are exact in f32 and
    bf16), for plain and packed engines and through voxel_pr_streaming."""
    import jax

    from flypylib_tpu.models.zoo import baseline_model
    from flypylib_tpu.ops.matching import voxel_pr, voxel_pr_streaming
    from flypylib_tpu.ops.packed_conv import packed_spec

    spec = baseline_model(features=(4, 6), dilations=(1, 2),
                          head_features=8)
    variables = spec.init(jax.random.PRNGKey(0))
    vol_u8 = (rng.random((26, 24, 22)) * 255).astype(np.uint8)
    for s in (spec, packed_spec(spec)):
        ti = TiledInference(s, variables, tile_out=16)
        a = ti.infer(vol_u8)
        b = ti.infer(vol_u8.astype(np.float32))
        np.testing.assert_array_equal(a, b)
    labels = (rng.random(vol_u8.shape) > 0.9).astype(np.float32)
    ref = voxel_pr(TiledInference(spec, variables, tile_out=16)
                   .infer(vol_u8.astype(np.float32)), labels)
    got = voxel_pr_streaming(spec, variables, vol_u8, labels, slab=8,
                             tile_out=16)
    np.testing.assert_array_equal(ref["precision"], got["precision"])
    np.testing.assert_array_equal(ref["recall"], got["recall"])
