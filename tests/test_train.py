"""Train smoke tests: loss decreases on synthetic data; determinism under
fixed PRNG (SURVEY.md section 4 item 5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flypylib_tpu.io.synapses import Tbars, make_training_volumes
from flypylib_tpu.models.zoo import baseline_model
from flypylib_tpu.train.trainer import TrainConfig, Trainer
from tests.conftest import make_blob_volume


def synthetic_task(size=48, n_pts=6, seed=0):
    """Bright Gaussian blobs on noise; labels = balls at blob centers."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(8, size - 8, (n_pts, 3))
    image, _ = make_blob_volume((size,) * 3, centers=centers, sigma=2.0)
    image = image + rng.normal(0, 0.05, image.shape).astype(np.float32)
    tb = Tbars(locs=centers.astype(np.float64))
    labels, mask = make_training_volumes(tb, size, radius=2, radius_ign=4)
    return image.astype(np.float32), labels, mask, tb


def small_spec():
    return baseline_model(features=(8, 8), dilations=(1, 1), head_features=16,
                          dtype=jnp.float32)


def test_loss_decreases():
    image, labels, mask, _ = synthetic_task()
    cfg = TrainConfig(patch_size=17, batch_size=16, steps_per_epoch=30,
                      learning_rate=3e-3)
    tr = Trainer(small_spec(), cfg, seed=0)
    hist = tr.fit(image, labels, mask, epochs=2)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert hist[-1]["loss"] < 0.4


def test_determinism():
    image, labels, mask, _ = synthetic_task()
    # engine pinned to plain to keep this quick invariant in the fast
    # tier (auto->packed at batch 8 costs ~7 s more of CPU compiles;
    # packed determinism is covered by test_packed_engine_matches_plain)
    cfg = TrainConfig(patch_size=13, batch_size=8, steps_per_epoch=5,
                      engine="plain")
    h1 = Trainer(small_spec(), cfg, seed=7).fit(image, labels, mask)
    h2 = Trainer(small_spec(), cfg, seed=7).fit(image, labels, mask)
    assert h1[0]["loss"] == h2[0]["loss"]


def test_masked_loss_ignores_masked_voxels():
    from flypylib_tpu.train.trainer import masked_bce_loss

    logits = jnp.array([[10.0, -10.0]])
    labels = jnp.array([[0.0, 0.0]])
    # first voxel badly wrong but masked out -> loss ~ 0
    mask = jnp.array([[0.0, 1.0]])
    assert float(masked_bce_loss(logits, labels, mask)) < 1e-3
    mask2 = jnp.array([[1.0, 1.0]])
    assert float(masked_bce_loss(logits, labels, mask2)) > 1.0


def test_checkpoint_roundtrip(tmp_path):
    image, labels, mask, _ = synthetic_task()
    cfg = TrainConfig(patch_size=13, batch_size=4, steps_per_epoch=2)
    tr = Trainer(small_spec(), cfg, seed=0)
    tr.fit(image, labels, mask)
    path = str(tmp_path / "ckpt")
    tr.save(path)
    tr2 = Trainer(small_spec(), cfg, seed=1)
    tr2.init_state()
    tr2.restore(path)
    for a, b in zip(
        jax.tree_util.tree_leaves(tr.state.params),
        jax.tree_util.tree_leaves(tr2.state.params),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_multi_volume_training():
    """Train over a list of differently-shaped labeled volumes."""
    imgs, labs, msks = [], [], []
    for seed, size in [(0, 40), (1, 48)]:
        im, lb, mk, _ = synthetic_task(size=size, seed=seed)
        imgs.append(im)
        labs.append(lb)
        msks.append(mk)
    cfg = TrainConfig(patch_size=13, batch_size=8, steps_per_epoch=10,
                      learning_rate=3e-3)
    tr = Trainer(small_spec(), cfg, seed=0)
    hist = tr.fit(imgs, labs, msks, epochs=2)
    assert np.isfinite(hist[-1]["loss"])
    assert hist[-1]["loss"] < hist[0]["loss"] * 1.5  # runs without blow-up


def test_uint8_image_training():
    image, labels, mask, _ = synthetic_task()
    img8 = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    cfg = TrainConfig(patch_size=13, batch_size=8, steps_per_epoch=5)
    tr = Trainer(small_spec(), cfg, seed=0)
    hist = tr.fit(img8, labels, mask, epochs=1)
    assert np.isfinite(hist[0]["loss"])


def test_fit_validation_metrics(tmp_path):
    """Held-out voxel/obj PR + val loss land in history and MetricsLog."""
    from flypylib_tpu.utils.metrics import MetricsLog

    image, labels, mask, tb = synthetic_task(size=32, n_pts=4, seed=0)
    v_img, v_lab, v_mask, v_tb = synthetic_task(size=32, n_pts=4, seed=1)
    spec = small_spec()
    cfg = TrainConfig(patch_size=13, batch_size=8, steps_per_epoch=5,
                      learning_rate=3e-3)
    tr = Trainer(spec, cfg, seed=0)
    log = MetricsLog(str(tmp_path / "metrics.jsonl"))
    hist = tr.fit(
        image, labels, mask, epochs=2,
        val_data=(v_img, v_lab, v_mask), val_tbars=v_tb,
        val_threshold=0.5, metrics_log=log,
    )
    for key in ("val_loss", "val_voxel_precision", "val_voxel_recall",
                "val_obj_precision", "val_obj_recall"):
        assert key in hist[0], key
        assert np.isfinite(hist[0][key])
    assert len(log.records) == 2
    assert "val_loss" in log.records[0]


def test_fit_val_every(tmp_path):
    image, labels, mask, _ = synthetic_task(size=32, n_pts=3, seed=2)
    spec = small_spec()
    cfg = TrainConfig(patch_size=13, batch_size=4, steps_per_epoch=2)
    tr = Trainer(spec, cfg, seed=0)
    hist = tr.fit(
        image, labels, mask, epochs=3,
        val_data=(image, labels, mask), val_every=2,
    )
    assert "val_loss" in hist[0]
    assert "val_loss" not in hist[1]
    assert "val_loss" in hist[2]


def test_validation_engine_cached(monkeypatch):
    """Validation reuses ONE TiledInference across epochs (a fresh engine
    per epoch re-jits the tile forward)."""
    import flypylib_tpu.infer.tiled as tiled_mod

    calls = []
    real = tiled_mod.TiledInference

    class Counting(real):
        def __init__(self, *a, **kw):
            calls.append(1)
            super().__init__(*a, **kw)

    monkeypatch.setattr(tiled_mod, "TiledInference", Counting)

    image, labels, mask, _ = synthetic_task(size=32, n_pts=3, seed=0)
    spec = small_spec()
    cfg = TrainConfig(patch_size=13, batch_size=4, steps_per_epoch=2)
    tr = Trainer(spec, cfg, seed=0)
    tr.fit(image, labels, mask, epochs=3, val_data=(image, labels, mask))
    assert len(calls) == 1  # one engine, three validation epochs
    assert tr._val_engine is not None


def test_fit_mesh_dp_matches_single_chip():
    """Trainer.fit(mesh=...) (public mesh-DP entry) == single-device fit
    with the same seed — params bitwise-comparable."""
    from flypylib_tpu.parallel import make_mesh

    image, labels, mask, _ = synthetic_task(size=24, n_pts=3, seed=0)
    spec = small_spec()
    cfg = TrainConfig(patch_size=13, batch_size=8, steps_per_epoch=3)

    tr_single = Trainer(spec, cfg, seed=0)
    tr_single.fit(image, labels, mask, epochs=2)

    tr_dp = Trainer(spec, cfg, seed=0)
    tr_dp.fit(image, labels, mask, epochs=2, mesh=make_mesh(4, axis="data"))

    import jax

    for a, b in zip(jax.tree_util.tree_leaves(tr_single.state.params),
                    jax.tree_util.tree_leaves(tr_dp.state.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_network_train_mesh_kwarg():
    """FplNetwork.train forwards mesh= to the trainer (public API row)."""
    from flypylib_tpu.network import FplNetwork
    from flypylib_tpu.parallel import make_mesh

    image, labels, mask, _ = synthetic_task(size=24, n_pts=3, seed=1)
    net = FplNetwork(
        "baseline", features=(4,), dilations=(1,), head_features=8,
        train_config=TrainConfig(patch_size=13, batch_size=8,
                                 steps_per_epoch=2),
    )
    hist = net.train(image, labels, mask, epochs=1,
                     mesh=make_mesh(4, axis="data"))
    assert np.isfinite(hist[0]["loss"])


def test_packed_engine_matches_plain():
    """engine="packed" optimizes the same objective: with an f32 model
    and identical patch geometry (same sampling stream), the packed and
    plain trajectories match to re-association tolerance."""
    from flypylib_tpu.ops.packed_conv import packed_spec

    image, labels, mask, _ = synthetic_task()
    spec = baseline_model(features=(8, 8), dilations=(1, 2),
                          head_features=16, dtype=jnp.float32)
    p = packed_spec(spec).valid_size(18)
    # identical sampling requires the plain engine to resolve the same
    # patch (ConvStack accepts any size, so this holds by construction)
    assert spec.valid_size(p) == p
    h_plain, h_packed, params = [], [], []
    for engine in ("plain", "packed"):
        cfg = TrainConfig(patch_size=p, batch_size=8, steps_per_epoch=8,
                          engine=engine)
        tr = Trainer(spec, cfg, seed=3)
        hist = tr.fit(image, labels, mask, epochs=2)
        (h_plain if engine == "plain" else h_packed).extend(hist)
        params.append(tr.state.params)
    for a, b in zip(h_plain, h_packed):
        assert abs(a["loss"] - b["loss"]) < 1e-3
    for x, y in zip(jax.tree_util.tree_leaves(params[0]),
                    jax.tree_util.tree_leaves(params[1])):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=2e-3, atol=2e-4)


def test_packed_engine_rejects_unsupported_module():
    """engine="packed" accepts ConvStack and UNetValid (the U-Net path
    is trained end-to-end in tests/test_packed_unet.py) but still
    refuses arbitrary modules with a clear error."""
    from dataclasses import dataclass

    import jax.numpy as jnp

    from flypylib_tpu.models.layers import Module, conv
    from flypylib_tpu.models.zoo import ModelSpec

    @dataclass(frozen=True)
    class Custom(Module):
        def forward(self, s, x, train=False):
            return conv(s, x, 1, (3, 3, 3), dtype=jnp.float32)

    spec = ModelSpec(name="custom", module=Custom(), context=1)
    cfg = TrainConfig(engine="packed")
    with pytest.raises(ValueError, match="ConvStack or UNetValid"):
        Trainer(spec, cfg, seed=0).fit(*synthetic_task()[:3])


def test_unknown_engine_rejected():
    cfg = TrainConfig(engine="fast")
    with pytest.raises(ValueError, match="unknown engine"):
        Trainer(small_spec(), cfg, seed=0).fit(*synthetic_task()[:3])


def test_packed_engine_mesh_dp_matches_single_chip():
    """Invariant 4 holds for engine="packed" too: the dp and single-chip
    paths share the packed step body, so same seed => same params."""
    from flypylib_tpu.parallel import make_mesh

    image, labels, mask, _ = synthetic_task(size=24, n_pts=3, seed=0)
    spec = baseline_model(features=(8, 8), dilations=(1, 2),
                          head_features=16, dtype=jnp.float32)
    cfg = TrainConfig(patch_size=14, batch_size=8, steps_per_epoch=3,
                      engine="packed")

    tr_single = Trainer(spec, cfg, seed=0)
    tr_single.fit(image, labels, mask, epochs=2)

    tr_dp = Trainer(spec, cfg, seed=0)
    tr_dp.fit(image, labels, mask, epochs=2, mesh=make_mesh(4, axis="data"))

    for a, b in zip(jax.tree_util.tree_leaves(tr_single.state.params),
                    jax.tree_util.tree_leaves(tr_dp.state.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_auto_engine_resolution():
    """engine="auto" (the default) resolves by batch size (the
    _PACKED_BATCH_CROSSOVER default) and falls
    back to plain when the model has no differentiable packed forward."""
    from flypylib_tpu.models.zoo import unet
    from flypylib_tpu.train.trainer import resolve_engine

    spec = small_spec()
    assert TrainConfig().engine == "auto"
    assert resolve_engine(spec, TrainConfig(batch_size=32)) == "packed"
    assert resolve_engine(spec, TrainConfig(batch_size=128)) == "plain"
    # explicit engines pass through regardless of batch
    assert resolve_engine(
        spec, TrainConfig(batch_size=128, engine="packed")) == "packed"
    assert resolve_engine(
        spec, TrainConfig(batch_size=8, engine="plain")) == "plain"
    # BatchNorm ConvStack: packed forward_train is inference-mode
    # semantics (folds running stats), so auto stays plain
    from flypylib_tpu.models.zoo import ConvStack, ModelSpec

    bn_mod = ConvStack(features=(8, 8), dilations=(1, 1),
                       head_features=16, use_batchnorm=True)
    bn = ModelSpec(name="bn", module=bn_mod, context=2, min_size=5)
    assert resolve_engine(bn, TrainConfig(batch_size=8)) == "plain"
    # U-Net has a differentiable packed forward (tiny config: the
    # geometry probe of the full zoo unet costs ~40 s of CPU compiles)
    tiny_unet = unet(base_features=4, levels=1, convs_per_stage=1)
    assert resolve_engine(tiny_unet, TrainConfig(batch_size=8)) == "packed"
    # NB test_loss_decreases exercises the auto default end-to-end
    # (batch 16 -> packed)


def test_validation_uses_infer_engine_tiling():
    """_validate routes through the network's infer_spec with the
    default_tiling policy: U-Net validation gets
    the cover-regime tile, not the constructor default (64, 1)."""
    import numpy as np

    from flypylib_tpu.infer.tiled import default_tiling
    from flypylib_tpu.models.zoo import unet
    from flypylib_tpu.network import FplNetwork

    net = FplNetwork(unet(base_features=4, levels=1, convs_per_stage=1))
    tr = net.trainer
    # the packed inference spec flows from FplNetwork into the Trainer
    assert tr.infer_spec is net.infer_spec
    assert tr.infer_spec is not tr.spec
    tr.init_state()
    n = net.infer_spec.valid_size(2 * net.infer_spec.context + 12)
    rng = np.random.default_rng(0)
    img = rng.random((n, n, n), np.float32)
    lab = np.zeros((n, n, n), np.float32)
    msk = np.ones((n, n, n), np.float32)
    out = tr._validate((img, lab, msk), None, 0.5, 3, 10.0)
    assert "val_loss" in out and np.isfinite(out["val_loss"])
    want = default_tiling(net.infer_spec, (n, n, n))
    assert tr._val_engine_key == want  # spy: engine built at the policy tile
    assert tr._val_engine.spec is net.infer_spec
    # cover regime for the pooling topology: one tile spans the volume
    assert tr._val_engine.tile_out >= n - 2 * net.infer_spec.context
