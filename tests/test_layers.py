"""The jax.lax module layer (models/layers.py) and the zoo models on it:
variables-tree layout, layer arithmetic against lax and numpy
references, BatchNorm statistics, and the init/apply contract."""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from flypylib_tpu.models import layers
from flypylib_tpu.models.zoo import (
    ConvStack,
    UNetValid,
    baseline_model,
    unet,
    vgg_like,
)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def _conv(i, k, ci, co):
    return {f"params/Conv_{i}/kernel": (k, k, k, ci, co),
            f"params/Conv_{i}/bias": (co,)}


def _stack_layout(features, head):
    out, ci = {}, 1
    for i, f in enumerate(features):
        out.update(_conv(i, 3, ci, f))
        ci = f
    n = len(features)
    out.update(_conv(n, 1, ci, head))
    out.update(_conv(n + 1, 1, head, 1))
    return out


def _unet_layout():
    out = {}
    convs = [(1, 24), (24, 24), (24, 48), (48, 48), (48, 96), (96, 96),
             (96, 48), (48, 48), (48, 24), (24, 24)]
    for i, (ci, co) in enumerate(convs):
        out.update(_conv(i, 3, ci, co))
    out.update(_conv(10, 1, 24, 1))
    for i, (ci, co) in enumerate([(96, 48), (48, 24)]):
        out[f"params/ConvTranspose_{i}/kernel"] = (2, 2, 2, ci, co)
        out[f"params/ConvTranspose_{i}/bias"] = (co,)
    return out


def _bn_layout():
    out = _stack_layout((6, 8), 8)
    for i, f in enumerate((6, 8)):
        for leaf in ("scale", "bias"):
            out[f"params/BatchNorm_{i}/{leaf}"] = (f,)
        for leaf in ("mean", "var"):
            out[f"batch_stats/BatchNorm_{i}/{leaf}"] = (f,)
    return out


_LAYOUTS = {
    "baseline": (lambda: baseline_model().module,
                 lambda: _stack_layout((24, 32, 48, 64), 96), 17),
    "vgg_like": (lambda: vgg_like().module,
                 lambda: _stack_layout((32, 32, 48, 48, 64, 64, 96), 128),
                 33),
    "unet": (lambda: unet().module, _unet_layout, 44),
    "batchnorm": (
        lambda: ConvStack(features=(6, 8), dilations=(1, 2), head_features=8,
                          use_batchnorm=True),
        _bn_layout, 9,
    ),
}


@pytest.mark.parametrize("name", sorted(_LAYOUTS))
def test_variables_tree_layout(name):
    """init keeps the checkpoint / Keras-import layout: Conv_i,
    ConvTranspose_i, BatchNorm_i by call order, DHWIO kernels, f32."""
    make_module, layout, s = _LAYOUTS[name]
    v = jax.eval_shape(
        lambda: make_module().init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, s, s, s, 1)))
    )
    assert _flat(v) == layout()
    assert all(a.dtype == jnp.float32 for a in jax.tree.leaves(v))


@dataclass(frozen=True)
class _OneConv(layers.Module):
    features: int = 3
    dilation: int = 1

    def forward(self, s, x, train=False):
        return layers.conv(s, x, self.features, (3, 3, 3),
                           dilation=self.dilation, dtype=jnp.float32)


def _np_conv(x, w, b, d):
    """Direct valid cross-correlation: x (D,H,W,Ci), w (3,3,3,Ci,Co)."""
    k = w.shape[0]
    span = d * (k - 1)
    out = np.zeros(tuple(n - span for n in x.shape[:3]) + (w.shape[-1],))
    for a in range(k):
        for bb in range(k):
            for c in range(k):
                patch = x[a * d: a * d + out.shape[0],
                          bb * d: bb * d + out.shape[1],
                          c * d: c * d + out.shape[2]]
                out += patch @ w[a, bb, c]
    return out + b


@pytest.mark.parametrize("dilation", [1, 2])
def test_conv_matches_lax_and_numpy(rng, dilation):
    m = _OneConv(dilation=dilation)
    x = jnp.asarray(rng.normal(size=(2, 9, 10, 11, 2)), jnp.float32)
    v = m.init(jax.random.PRNGKey(0), x)
    v = jax.tree.map(lambda a: a + 0.1, v)
    got = np.asarray(m.apply(v, x))
    p = v["params"]["Conv_0"]
    ref = lax.conv_general_dilated(
        x, p["kernel"], (1, 1, 1), "VALID", rhs_dilation=(dilation,) * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
    ) + p["bias"]
    np.testing.assert_array_equal(got, np.asarray(ref))
    for i in range(2):
        np.testing.assert_allclose(
            got[i], _np_conv(np.asarray(x[i], np.float64),
                             np.asarray(p["kernel"], np.float64),
                             np.asarray(p["bias"], np.float64), dilation),
            rtol=1e-4, atol=1e-4,
        )


@dataclass(frozen=True)
class _Up(layers.Module):
    def forward(self, s, x, train=False):
        return layers.conv_transpose(s, x, 3, 2, dtype=jnp.float32)


def test_conv_transpose_reads_flipped_tap(rng):
    """Kernel-2 stride-2 ConvTranspose: out[2r + p] = x[r] @ K[1 - p] + b
    (the identity the packed U-Net engine folds into its weights)."""
    m = _Up()
    x = jnp.asarray(rng.normal(size=(1, 3, 4, 5, 2)), jnp.float32)
    v = jax.tree.map(lambda a: a + 0.2, m.init(jax.random.PRNGKey(1), x))
    got = np.asarray(m.apply(v, x))[0]
    k = np.asarray(v["params"]["ConvTranspose_0"]["kernel"], np.float64)
    b = np.asarray(v["params"]["ConvTranspose_0"]["bias"], np.float64)
    xn = np.asarray(x[0], np.float64)
    ref = np.zeros((6, 8, 10, 3))
    for pz in range(2):
        for py in range(2):
            for px in range(2):
                ref[pz::2, py::2, px::2] = (
                    xn @ k[1 - pz, 1 - py, 1 - px] + b
                )
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@dataclass(frozen=True)
class _BN(layers.Module):
    def forward(self, s, x, train=False):
        return layers.batch_norm(s, x, train, dtype=jnp.float32)


def test_batchnorm_train_normalizes_and_updates_stats(rng):
    m = _BN()
    x = jnp.asarray(rng.normal(2.0, 3.0, size=(4, 5, 6, 7, 3)), jnp.float32)
    v = m.init(jax.random.PRNGKey(0), x)
    v["params"]["BatchNorm_0"]["scale"] = jnp.asarray([1.0, 2.0, 0.5])
    v["params"]["BatchNorm_0"]["bias"] = jnp.asarray([0.0, 1.0, -1.0])
    y, upd = m.apply(v, x, train=True, mutable=["batch_stats"])
    xn = np.asarray(x, np.float64).reshape(-1, 3)
    mean, var = xn.mean(0), xn.var(0)
    ref = (xn - mean) / np.sqrt(var + layers.BN_EPSILON)
    ref = ref * [1.0, 2.0, 0.5] + [0.0, 1.0, -1.0]
    np.testing.assert_allclose(np.asarray(y).reshape(-1, 3), ref,
                               rtol=1e-4, atol=1e-4)
    st = upd["batch_stats"]["BatchNorm_0"]
    mom = layers.BN_MOMENTUM
    np.testing.assert_allclose(st["mean"], (1 - mom) * mean, rtol=1e-5)
    np.testing.assert_allclose(st["var"], mom + (1 - mom) * var, rtol=1e-5)


def test_batchnorm_eval_uses_running_stats(rng):
    m = _BN()
    x = jnp.asarray(rng.normal(size=(2, 3, 4, 5, 3)), jnp.float32)
    v = m.init(jax.random.PRNGKey(0), x)
    v["batch_stats"]["BatchNorm_0"] = {
        "mean": jnp.asarray([0.5, -1.0, 2.0]),
        "var": jnp.asarray([4.0, 1.0, 0.25]),
    }
    y = np.asarray(m.apply(v, x, train=False))
    ref = (np.asarray(x) - [0.5, -1.0, 2.0]) / np.sqrt(
        np.asarray([4.0, 1.0, 0.25]) + layers.BN_EPSILON
    )
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-5)
    # eval mode records no statistics
    _, upd = m.apply(v, x, train=False, mutable=["batch_stats"])
    assert upd == {}


def test_max_pool_matches_numpy(rng):
    x = rng.normal(size=(2, 6, 8, 4, 3)).astype(np.float32)
    got = np.asarray(layers.max_pool(jnp.asarray(x), 2))
    ref = x.reshape(2, 3, 2, 4, 2, 2, 2, 3).max(axis=(2, 4, 6))
    np.testing.assert_array_equal(got, ref)


def test_apply_mutable_contract(rng):
    """mutable=False returns the output; a mutable list returns
    (output, updates); initializing never updates running stats."""
    m = ConvStack(features=(4,), dilations=(1,), head_features=4,
                  use_batchnorm=True, dtype=jnp.float32)
    x = jnp.asarray(rng.normal(size=(2, 7, 7, 7, 1)), jnp.float32)
    v = m.init(jax.random.PRNGKey(0), x, train=True)
    np.testing.assert_array_equal(v["batch_stats"]["BatchNorm_0"]["mean"],
                                  np.zeros(4, np.float32))
    out = m.apply(v, x)
    assert out.shape == (2, 5, 5, 5, 1)
    out2, upd = m.apply(v, x, mutable=[])
    np.testing.assert_array_equal(out, out2)
    assert upd == {}
    _, upd = m.apply(v, x, train=True, mutable=["batch_stats"])
    assert set(upd) == {"batch_stats"}
    assert set(upd["batch_stats"]) == {"BatchNorm_0"}
    with pytest.raises(KeyError, match="Conv_0"):
        m.apply({"params": {}}, x)


def test_modules_hash_by_value():
    """Frozen dataclasses: equal configs hash equal, so geometry caches
    (lru_cache keyed on the module) hit across instances."""
    assert hash(ConvStack()) == hash(ConvStack())
    assert ConvStack() == baseline_model().module
    assert UNetValid(base_features=8) != UNetValid(base_features=16)
    assert unet().context == 20 and unet().size_multiple == 4


# -- bitwise parity with the former Flax definitions -------------------------


def _flax_models():
    nn = pytest.importorskip("flax.linen")

    class FConvStack(nn.Module):
        features: tuple = (24, 32, 48, 64)
        dilations: tuple = (1, 1, 2, 2)
        head_features: int = 96
        dtype: object = jnp.bfloat16
        use_batchnorm: bool = False

        @nn.compact
        def __call__(self, x, train=False):
            x = x.astype(self.dtype)
            for f, d in zip(self.features, self.dilations):
                x = nn.Conv(f, (3, 3, 3), padding="VALID",
                            kernel_dilation=(d, d, d), dtype=self.dtype)(x)
                if self.use_batchnorm:
                    x = nn.BatchNorm(use_running_average=not train,
                                     dtype=self.dtype)(x)
                x = nn.relu(x)
            x = nn.relu(nn.Conv(self.head_features, (1, 1, 1),
                                dtype=self.dtype)(x))
            return nn.Conv(1, (1, 1, 1), dtype=jnp.float32)(x).astype(
                jnp.float32)

    class FUNet(nn.Module):
        dtype: object = jnp.bfloat16

        @nn.compact
        def __call__(self, x, train=False):
            x = x.astype(self.dtype)

            def block(x, f):
                for _ in range(2):
                    x = nn.relu(nn.Conv(f, (3, 3, 3), padding="VALID",
                                        dtype=self.dtype)(x))
                return x

            skips, f = [], 24
            for _ in range(2):
                x = block(x, f)
                skips.append(x)
                x = nn.max_pool(x, (2, 2, 2), strides=(2, 2, 2))
                f *= 2
            x = block(x, f)
            for skip in reversed(skips):
                f //= 2
                x = nn.ConvTranspose(f, (2, 2, 2), strides=(2, 2, 2),
                                     dtype=self.dtype)(x)
                c = [(skip.shape[i] - x.shape[i]) // 2 for i in (1, 2, 3)]
                skip = skip[:, c[0]:c[0] + x.shape[1],
                            c[1]:c[1] + x.shape[2], c[2]:c[2] + x.shape[3]]
                x = block(jnp.concatenate([skip, x], axis=-1), f)
            return nn.Conv(1, (1, 1, 1), dtype=jnp.float32)(x).astype(
                jnp.float32)

    return FConvStack, FUNet


@pytest.mark.parametrize("name", ["baseline", "unet", "batchnorm"])
def test_layers_match_flax_bitwise(rng, name):
    """Same initial weights from a seed, same outputs, same gradients
    (and the same BatchNorm running-stat updates) as the Flax modules the
    zoo used to be written in — so existing checkpoints and seeds load
    and behave unchanged."""
    FConvStack, FUNet = _flax_models()
    if name == "baseline":
        mine, theirs, s = ConvStack(), FConvStack(), 17
    elif name == "unet":
        mine, theirs, s = UNetValid(), FUNet(), 44
    else:
        kw = dict(features=(6, 8), dilations=(1, 2), head_features=8,
                  use_batchnorm=True)
        mine, theirs, s = ConvStack(**kw), FConvStack(**kw), 12
    x = jnp.asarray(rng.normal(size=(2, s, s, s, 1)), jnp.float32)
    v = theirs.init(jax.random.PRNGKey(0), x[:1])
    # same seed, same initial weights
    jax.tree.map(np.testing.assert_array_equal,
                 mine.init(jax.random.PRNGKey(0), x[:1]), v)
    v = jax.tree.map(
        lambda a: a + 0.05 * jnp.asarray(rng.normal(size=a.shape), a.dtype),
        v,
    )
    np.testing.assert_array_equal(mine.apply(v, x), theirs.apply(v, x))
    grad = [
        jax.grad(lambda p, m=m: m.apply({**v, "params": p}, x).sum())(
            v["params"])
        for m in (mine, theirs)
    ]
    jax.tree.map(np.testing.assert_array_equal, grad[0], grad[1])
    if "batch_stats" in v:
        a = mine.apply(v, x, train=True, mutable=["batch_stats"])
        b = theirs.apply(v, x, train=True, mutable=["batch_stats"])
        np.testing.assert_array_equal(a[0], b[0])
        jax.tree.map(np.testing.assert_array_equal, a[1], b[1])
