"""Packed U-Net engine == plain UNetValid (same params tree)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flypylib_tpu.models.zoo import unet
from flypylib_tpu.ops.packed_unet import packed_unet_spec


@pytest.fixture(scope="module")
def small_unet():
    spec = unet(base_features=4, levels=2, convs_per_stage=2,
                dtype=jnp.float32)
    pspec = packed_unet_spec(spec)
    assert pspec is not None
    variables = spec.init(jax.random.PRNGKey(0), pspec.min_size)
    return spec, pspec, variables


def test_packed_unet_matches_plain(small_unet, rng):
    spec, pspec, variables = small_unet
    s = pspec.min_size
    x = jnp.asarray(rng.random((1, s, s, s, 1)), jnp.float32)
    plain = np.asarray(spec.module.apply(variables, x, train=False))
    packed = np.asarray(pspec.module.apply(variables, x, train=False))
    assert plain.shape == packed.shape
    np.testing.assert_allclose(packed, plain, rtol=1e-5, atol=1e-5)


def test_packed_unet_matches_plain_bf16(rng):
    """bf16 packed engine matches the f32 plain net to bf16 tolerance."""
    spec32 = unet(base_features=4, levels=1, convs_per_stage=1,
                  dtype=jnp.float32)
    spec16 = unet(base_features=4, levels=1, convs_per_stage=1)
    pspec = packed_unet_spec(spec16)
    variables = spec32.init(jax.random.PRNGKey(1), pspec.min_size)
    s = pspec.valid_size(pspec.min_size + pspec.size_multiple)
    x = jnp.asarray(rng.random((1, s, s, s, 1)), jnp.float32)
    plain = np.asarray(spec32.module.apply(variables, x, train=False))
    packed = np.asarray(pspec.module.apply(variables, x, train=False))
    np.testing.assert_allclose(packed, plain, rtol=5e-2, atol=5e-2)


def test_packed_unet_geometry_exports(small_unet):
    spec, pspec, variables = small_unet
    # stricter-or-equal constraints than the plain net
    assert pspec.size_multiple % spec.size_multiple == 0
    assert pspec.context == spec.context
    # a second probed-valid size also matches
    s = pspec.valid_size(pspec.min_size + pspec.size_multiple)
    assert pspec.is_valid_size(s)


def test_packed_unet_tiled_equals_monolithic(small_unet, rng):
    """The packed U-Net composes with the tile planner bitwise."""
    from flypylib_tpu.infer.tiled import TiledInference

    spec, pspec, variables = small_unet
    vol = rng.random((40, 36, 34)).astype(np.float32)
    ti_small = TiledInference(pspec, variables, tile_out=16)
    ti_big = TiledInference(pspec, variables, tile_out=48)
    a = ti_small.infer(vol)
    b = ti_big.infer(vol)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_packed_unet_non_unet_returns_none():
    from flypylib_tpu.models.zoo import baseline_model

    assert packed_unet_spec(baseline_model()) is None


def test_crop_packed_matches_unpack_crop_repack(rng):
    """crop_packed == pack(unpack[crop]) for even AND odd start offsets."""
    from flypylib_tpu.ops.packed_conv import pack_volume, unpack_volume
    from flypylib_tpu.ops.packed_unet import crop_packed

    full = jnp.asarray(rng.random((2, 12, 14, 16, 3)), jnp.float32)
    x = pack_volume(full)
    for starts, sizes in [
        ((2, 4, 0), (8, 6, 10)),   # even starts
        ((1, 3, 5), (8, 6, 4)),    # odd starts (parity swap)
        ((1, 2, 3), (10, 8, 6)),   # mixed
    ]:
        ref = pack_volume(
            unpack_volume(x)[
                :,
                starts[0] : starts[0] + sizes[0],
                starts[1] : starts[1] + sizes[1],
                starts[2] : starts[2] + sizes[2],
                :,
            ]
        )
        got = crop_packed(x, starts, sizes)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_pool_pack_matches_transpose_form(rng):
    """pool_pack (strided slices) == pack_volume(parity_group_max(x))."""
    from flypylib_tpu.ops.packed_conv import pack_volume
    from flypylib_tpu.ops.packed_unet import parity_group_max, pool_pack

    x = jnp.asarray(rng.random((2, 8, 10, 12, 24)), jnp.float32)
    ref = pack_volume(parity_group_max(x))
    got = pool_pack(x)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_unet_forward_train_matches_plain_and_grads(small_unet, rng):
    """The differentiable packed U-Net forward (forward_train): same
    values and same gradients as the plain UNetValid train forward, to
    accumulation tolerance (exact linear re-association; f32 model
    makes it tight).  Mirrors the ConvStack test in
    tests/test_packed_conv.py."""
    spec, pspec, variables = small_unet
    s = pspec.min_size
    x = jnp.asarray(rng.normal(size=(2, s, s, s, 1)).astype(np.float32))

    ref = spec.module.apply(variables, x, train=True)
    got = pspec.module.forward_train(variables, x)
    np.testing.assert_allclose(
        np.asarray(ref), np.asarray(got), rtol=1e-5, atol=1e-5
    )

    def loss_plain(p):
        return jnp.mean(
            spec.module.apply({"params": p}, x, train=True) ** 2
        )

    def loss_packed(p):
        return jnp.mean(pspec.module.forward_train({"params": p}, x) ** 2)

    gp = jax.grad(loss_plain)(variables["params"])
    gq = jax.grad(loss_packed)(variables["params"])
    for a, b in zip(
        jax.tree_util.tree_leaves(gp), jax.tree_util.tree_leaves(gq)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5
        )


def test_unet_packed_engine_trains():
    """TrainConfig(engine="packed") resolves UNetValid models and the
    loss decreases (the full on-device sampling + augment + Adam step
    through the differentiable packed U-Net)."""
    from flypylib_tpu.train.trainer import TrainConfig, Trainer

    spec = unet(base_features=2, levels=1, convs_per_stage=1,
                dtype=jnp.float32)
    rng = np.random.default_rng(3)
    size = 48
    image = rng.integers(0, 256, (size,) * 3).astype(np.uint8)
    labels = (rng.random((size,) * 3) > 0.995).astype(np.float32)
    mask = np.ones((size,) * 3, np.float32)
    cfg = TrainConfig(patch_size=18, batch_size=4, augment=True,
                      steps_per_epoch=8, engine="packed")
    tr = Trainer(spec, cfg, seed=0)
    hist = tr.fit([image], [labels], [mask], epochs=3)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_fold_form_split_matches_concat(small_unet, rng):
    """fold_form="split" (the default)/"split0" (pre-concat two-conv
    decoder) matches the concat fold to f32-accumulation tolerance at
    every level."""
    from flypylib_tpu.ops.packed_unet import PackedUNet

    spec, pspec, variables = small_unet
    assert PackedUNet(spec.module).fold_form == "split"  # the default
    s = pspec.min_size
    x = jnp.asarray(rng.random((1, s, s, s, 1)), jnp.float32)
    ref = np.asarray(
        PackedUNet(spec.module, fold_form="concat").apply(variables, x)
    )
    for ff in ("split", "split0"):
        out = np.asarray(
            PackedUNet(spec.module, fold_form=ff).apply(variables, x)
        )
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    import pytest as _pytest

    with _pytest.raises(ValueError, match="fold_form"):
        PackedUNet(spec.module, fold_form="bogus")

