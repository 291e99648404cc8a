"""FplNetwork public API surface: train/infer/nms/evaluate end to end
(parity: flypylib's canonical loop, SURVEY.md section 1)."""

import jax.numpy as jnp
import numpy as np
import pytest

import flypylib_tpu as fpl
from flypylib_tpu.io.synapses import Tbars
from flypylib_tpu.models.zoo import baseline_model
from flypylib_tpu.train.trainer import TrainConfig
from tests.conftest import make_blob_volume


@pytest.fixture(scope="module")
def trained_net():
    rng = np.random.default_rng(0)
    centers = rng.integers(8, 40, (6, 3))
    image, _ = make_blob_volume((48,) * 3, centers=centers, sigma=2.0)
    image = image + rng.normal(0, 0.05, image.shape).astype(np.float32)
    tb = Tbars(locs=centers.astype(np.float64))
    spec = baseline_model(features=(8, 8), dilations=(1, 1), head_features=16,
                          dtype=jnp.float32)
    net = fpl.FplNetwork(
        spec,
        train_config=TrainConfig(patch_size=17, batch_size=16,
                                 steps_per_epoch=40, learning_rate=3e-3),
    )
    hist = net.train(image.astype(np.float32), tbars=tb, epochs=4, radius=2)
    return net, image.astype(np.float32), tb, hist


def test_train_decreases_loss(trained_net):
    _, _, _, hist = trained_net
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_infer_and_detect(trained_net):
    net, image, tb, _ = trained_net
    prob = net.infer(image, tile_out=24)
    assert prob.shape == image.shape
    assert prob.min() >= 0 and prob.max() <= 1
    det = net.detect(image, window=3, threshold=0.3, tile_out=24)
    # detections land near the true centers
    curve = net.evaluate(det, tb, dist_thresh=3.0)
    assert curve["recall"][-1] > 0.8


def test_nms_components_verbs(trained_net):
    net, image, _, _ = trained_net
    prob = net.infer(image, tile_out=24)
    d1 = net.nms(prob, window=3, threshold=0.3)
    d2 = net.components(prob, threshold=0.3)
    assert len(d1) > 0 and len(d2) > 0


def test_checkpoint_roundtrip(trained_net, tmp_path):
    net, image, _, _ = trained_net
    prob1 = net.infer(image, tile_out=24)
    net.save(str(tmp_path / "ck"))
    spec2 = baseline_model(features=(8, 8), dilations=(1, 1),
                           head_features=16, dtype=jnp.float32)
    net2 = fpl.FplNetwork(spec2)
    net2.restore(str(tmp_path / "ck"))
    prob2 = net2.infer(image, tile_out=24)
    np.testing.assert_array_equal(prob1, prob2)


def test_model_zoo_names():
    for name in ("baseline", "vgg_like", "unet"):
        net = fpl.FplNetwork(name)
        assert net.context > 0


def test_evaluate_on_prob_map(trained_net):
    """evaluate() accepts a raw probability volume (runs NMS internally)."""
    net, image, tb, _ = trained_net
    prob = net.infer(image, tile_out=24)
    curve = net.evaluate(prob, tb, dist_thresh=3.0, window=3, threshold=0.3)
    assert "precision" in curve and "recall" in curve
    assert curve["num_gt"] == len(tb)


def test_unet_train_smoke():
    """U-Net trains end to end on the virtual CPU (config 4 smoke)."""
    from flypylib_tpu.models.zoo import unet

    spec = unet(base_features=4, levels=1, convs_per_stage=1,
                dtype=jnp.float32)
    rng = np.random.default_rng(0)
    size = spec.valid_size(36)
    image, _ = make_blob_volume((size,) * 3,
                                centers=[(12, 12, 12), (24, 24, 24)])
    labels = (image > 0.5).astype(np.float32)
    mask = np.ones_like(labels)
    net = fpl.FplNetwork(
        spec,
        train_config=TrainConfig(patch_size=spec.valid_size(20),
                                 batch_size=4, steps_per_epoch=10,
                                 learning_rate=1e-3),
    )
    hist = net.train(image.astype(np.float32), labels=labels, mask=mask,
                     epochs=2)
    assert np.isfinite(hist[-1]["loss"])
    det = net.detect(image.astype(np.float32), threshold=0.5,
                     tile_out=20, method="components")
    assert det is not None


def test_detect_large_verb(trained_net):
    """detect_large matches the monolithic detect on every input form
    (ndarray staged / streamed, (shape, read_fn) pair)."""
    net, image, _, _ = trained_net
    mono = net.detect(image, window=5, threshold=0.3, tile_out=24)
    staged = net.detect_large(image, window=5, threshold=0.3, core=24,
                              staged=True)
    streamed = net.detect_large(image, window=5, threshold=0.3, core=24,
                                staged=False)
    from flypylib_tpu.infer.large import array_reader

    pair = net.detect_large(array_reader(image), window=5, threshold=0.3,
                            core=24)
    assert len(mono) > 0
    for got in (staged, streamed, pair):
        assert len(got) == len(mono)
        np.testing.assert_array_equal(got.locs, mono.locs)
        np.testing.assert_array_equal(got.conf, mono.conf)


def test_detect_large_devices_passthrough(rng):
    """FplNetwork.detect_large forwards devices= to the staged path."""
    import jax

    from flypylib_tpu.network import FplNetwork

    net = FplNetwork("baseline", features=(4, 6), dilations=(1, 2),
                     head_features=8)
    vol = rng.random((36, 30, 30)).astype(np.float32)
    d1 = net.detect_large(vol, core=16, window=5, threshold=0.6,
                          staged=True)
    dn = net.detect_large(vol, core=16, window=5, threshold=0.6,
                          staged=True, devices=jax.devices()[:4])
    assert len(d1) == len(dn)
    np.testing.assert_array_equal(d1.locs, dn.locs)
    np.testing.assert_array_equal(d1.conf, dn.conf)


def test_evaluate_voxels_paths_agree(rng):
    """FplNetwork.evaluate_voxels: device path == host voxel_pr ==
    forced-streaming path."""
    from flypylib_tpu.infer.large import array_reader
    from flypylib_tpu.network import FplNetwork
    from flypylib_tpu.ops.matching import voxel_pr

    net = FplNetwork("baseline", features=(4, 6), dilations=(1, 2),
                     head_features=8)
    shape = (25, 22, 20)
    vol = rng.random(shape).astype(np.float32)
    labels = (rng.random(shape) > 0.9).astype(np.float32)
    mask = (rng.random(shape) > 0.1).astype(np.float32)
    ref = voxel_pr(net.infer(vol), labels, mask)
    dev = net.evaluate_voxels(vol, labels, mask)
    stream = net.evaluate_voxels(vol, labels, mask, slab=8)
    reader = net.evaluate_voxels(array_reader(vol), array_reader(labels),
                                 array_reader(mask))
    for got in (dev, stream, reader):
        np.testing.assert_array_equal(ref["thresholds"], got["thresholds"])
        np.testing.assert_array_equal(ref["precision"], got["precision"])
        np.testing.assert_array_equal(ref["recall"], got["recall"])


def test_staged_cutoff_hbm_aware():
    """The staged-vs-streaming auto cutoff is a bytes-on-device estimate
    (volume at wire dtype + f32 prob shell) vs the device budget — with
    a 16 GiB budget, in-RAM 1k^3 volumes stage at BOTH uint8 and f32
    and a 2k^3 volume streams; an 80 GB-class budget stages 2k^3 uint8."""
    from flypylib_tpu.network import _staged_fits_hbm

    class FakeVol:
        def __init__(self, size, itemsize):
            self.size = size
            self.nbytes = size * itemsize

    gib = 1024 ** 3
    lim = 16 * gib
    assert _staged_fits_hbm(FakeVol(gib, 1), bytes_limit=lim)  # ~5 GB
    assert _staged_fits_hbm(FakeVol(gib, 4), bytes_limit=lim)  # ~8 GB
    assert not _staged_fits_hbm(FakeVol(8 * gib, 1), bytes_limit=lim)
    assert _staged_fits_hbm(FakeVol(8 * gib, 1), bytes_limit=80 * gib)


def test_detection_verb_window_defaults_unified():
    """detect and detect_large share ONE default window (the same verb
    must not give different lists depending on volume size)."""
    import inspect

    import flypylib_tpu as fpl

    d = inspect.signature(fpl.FplNetwork.detect).parameters["window"]
    dl = inspect.signature(fpl.FplNetwork.detect_large).parameters["window"]
    assert d.default == dl.default == 5


def test_detect_large_auto_routing_uses_hbm_estimate(monkeypatch, rng):
    """staged=None routes through _staged_fits_hbm: True -> detect_staged,
    False -> detect_streaming (spy on both)."""
    import flypylib_tpu.network as net_mod
    from flypylib_tpu.models.zoo import baseline_model
    from flypylib_tpu.network import FplNetwork

    spec = baseline_model(features=(4,), dilations=(1,), head_features=8)
    net = FplNetwork(spec, packed=False)
    vol = rng.random((24, 24, 24)).astype(np.float32)

    calls = []
    import flypylib_tpu.infer.large as large_mod

    real_staged = large_mod.detect_staged
    real_streaming = large_mod.detect_streaming
    monkeypatch.setattr(
        large_mod, "detect_staged",
        lambda *a, **k: calls.append("staged") or real_staged(*a, **k),
    )
    monkeypatch.setattr(
        large_mod, "detect_streaming",
        lambda *a, **k: calls.append("streaming")
        or real_streaming(*a, **k),
    )
    monkeypatch.setattr(net_mod, "_staged_fits_hbm",
                        lambda v, n_devices=1, **kw: True)
    net.detect_large(vol, threshold=0.9, core=16)
    monkeypatch.setattr(net_mod, "_staged_fits_hbm",
                        lambda v, n_devices=1, **kw: False)
    net.detect_large(vol, threshold=0.9, core=16)
    assert calls == ["staged", "streaming"]


def test_staged_cutoff_device_fanout():
    """The cutoff estimate splits the prob shell across devices=
    (volume replicated; z-bands split the shell)."""
    from flypylib_tpu.network import _staged_fits_hbm

    class FakeVol:
        def __init__(self, size, itemsize):
            self.size = size
            self.nbytes = size * itemsize

    gib = 1024 ** 3
    # 1536^3 uint8: ~3.4 GB volume + 13.5 GB shell -> streams on one
    # 16 GiB device, stages on 4 (shell/4 = 3.4 GB; 6.8 GB < 0.6 * 16 GiB)
    big = FakeVol(int(1536 ** 3), 1)
    assert not _staged_fits_hbm(big, bytes_limit=16 * gib)
    assert _staged_fits_hbm(big, n_devices=4, bytes_limit=16 * gib)
