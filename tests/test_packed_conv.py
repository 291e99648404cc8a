"""Packed (space-to-depth) inference engine == plain ConvStack.

Pins the packed engine (ops/packed_conv.py): the packed rewrite is an
exact re-association of the same multiply-adds, so outputs must match the
plain ConvStack to accumulation tolerance, the packing round-trips must be
exact, and the packed spec must stay bitwise self-consistent tiled vs
monolithic (the engine invariant that makes it a drop-in ModelSpec).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flypylib_tpu.models.zoo import ConvStack, baseline_model, unet, vgg_like
from flypylib_tpu.ops.packed_conv import (
    PackedConvStack,
    pack_volume,
    pack_weight_d1,
    packed_spec,
    parity_merge,
    parity_split,
    unpack_volume,
)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


def test_pack_unpack_roundtrip(rng):
    x = jnp.asarray(rng.normal(size=(2, 8, 6, 4, 3)).astype(np.float32))
    assert jnp.array_equal(unpack_volume(pack_volume(x)), x)
    assert jnp.array_equal(parity_merge(parity_split(x)), x)


def test_pack_volume_layout(rng):
    """Packed channel ((pz*2+py)*2+px)*C + c holds original [2r+p]."""
    x = jnp.asarray(rng.normal(size=(1, 4, 4, 4, 2)).astype(np.float32))
    p = pack_volume(x)
    assert p.shape == (1, 2, 2, 2, 16)
    for pz in range(2):
        for py in range(2):
            for px in range(2):
                ch = ((pz * 2 + py) * 2 + px) * 2
                np.testing.assert_array_equal(
                    p[0, 1, 0, 1, ch : ch + 2],
                    x[0, 2 + pz, py, 2 + px],
                )


def test_packed_weight_conv_equivalence(rng):
    """One packed 2^3 conv == one valid 3^3 conv (f32, exact-ish)."""
    from jax import lax

    ci, co = 3, 5
    x = jnp.asarray(rng.normal(size=(1, 10, 8, 6, ci)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(3, 3, 3, ci, co)).astype(np.float32))
    ref = lax.conv_general_dilated(
        x, w, (1, 1, 1), "VALID",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
    )
    got = lax.conv_general_dilated(
        pack_volume(x), pack_weight_d1(w), (1, 1, 1), "VALID",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
    )
    got = unpack_volume(got)
    # packed output covers 2*(n_cells-1) == n-2 positions per dim
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "make",
    [
        lambda: baseline_model(dtype=jnp.float32),
        lambda: baseline_model(
            features=(6, 8), dilations=(1, 2), head_features=12,
            dtype=jnp.float32,
        ),
        lambda: vgg_like(
            features=(4, 6, 6, 8), dilations=(1, 1, 2, 4), head_features=8,
            dtype=jnp.float32,
        ),
    ],
    ids=["baseline", "mixed_d1_d2", "vgg_d124"],
)
def test_packed_apply_matches_convstack(rng, make):
    spec = make()
    pspec = packed_spec(spec)
    assert pspec is not None
    assert pspec.context == spec.context
    s = pspec.valid_size(spec.min_size + 7)
    variables = spec.init(jax.random.PRNGKey(0), s)
    x = jnp.asarray(rng.normal(size=(1, s, s, s, 1)).astype(np.float32))
    ref = spec.apply(variables, x, train=False)
    got = pspec.apply(variables, x, train=False)
    assert got.shape == ref.shape
    assert got.dtype == jnp.float32
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_packed_batchnorm_matches(rng):
    spec_module = ConvStack(
        features=(6, 8), dilations=(1, 2), head_features=8,
        dtype=jnp.float32, use_batchnorm=True,
    )
    from flypylib_tpu.models.zoo import ModelSpec

    spec = ModelSpec(name="bn", module=spec_module, context=3, min_size=7)
    pm = PackedConvStack(spec_module)
    s = 16
    variables = spec_module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, s, s, s, 1)), train=False
    )
    # nonzero running stats so the affine actually does something
    variables = jax.tree.map(
        lambda v: v + 0.3 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape)
        / max(v.size, 1),
        variables,
    )
    x = jnp.asarray(rng.normal(size=(1, s, s, s, 1)).astype(np.float32))
    ref = spec_module.apply(variables, x, train=False)
    got = pm.apply(variables, x, train=False)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_packed_spec_geometry_and_tiling(rng):
    """Tiled packed inference == monolithic packed inference, bitwise."""
    from flypylib_tpu.infer.tiled import TiledInference

    spec = baseline_model(
        features=(4, 6), dilations=(1, 2), head_features=8,
        dtype=jnp.float32,
    )
    pspec = packed_spec(spec)
    assert pspec.size_multiple >= 2
    variables = spec.init(jax.random.PRNGKey(1), pspec.min_size)
    vol = rng.random((30, 26, 22)).astype(np.float32)

    mono = TiledInference(pspec, variables, tile_out=64).infer(vol)
    tiled = TiledInference(pspec, variables, tile_out=12).infer(vol)
    np.testing.assert_array_equal(mono, tiled)

    # and the packed map matches the plain map to tolerance
    plain = TiledInference(spec, variables, tile_out=64).infer(vol)
    np.testing.assert_allclose(mono, plain, rtol=2e-4, atol=2e-4)


def test_packed_pipeline_detections(rng):
    """DetectPipeline on a packed spec: postprocess stays exact on the
    packed map (pinned against the scipy host reference)."""
    from flypylib_tpu.infer.pipeline import DetectPipeline
    from flypylib_tpu.infer.tiled import TiledInference
    from flypylib_tpu.ops.host_reference import nms_host

    spec = baseline_model(
        features=(4, 6), dilations=(1, 2), head_features=8,
        dtype=jnp.float32,
    )
    pspec = packed_spec(spec)
    variables = spec.init(jax.random.PRNGKey(2), pspec.min_size)
    vol = rng.random((28, 24, 24)).astype(np.float32)

    prob = TiledInference(pspec, variables, tile_out=64).infer(vol)
    thr = float(np.quantile(prob, 0.98))
    pipe = DetectPipeline(
        spec=pspec, variables=variables, vol_shape=vol.shape,
        tile_out=64, window=3, threshold=thr, run_cc=False,
    )
    det, _ = pipe(vol)
    host = nms_host(prob, window=3, threshold=thr)
    np.testing.assert_array_equal(det.locs, host.locs)
    np.testing.assert_allclose(det.conf, host.conf, rtol=1e-6)


def test_packed_spec_rejects_unet():
    assert packed_spec(unet(base_features=4, levels=1)) is None


def test_packed_train_delegates(rng):
    """train=True goes through the inner module unchanged."""
    spec = baseline_model(
        features=(4,), dilations=(1,), head_features=4, dtype=jnp.float32
    )
    pspec = packed_spec(spec)
    s = pspec.valid_size(spec.min_size + 5)
    variables = spec.init(jax.random.PRNGKey(0), s)
    x = jnp.asarray(rng.normal(size=(1, s, s, s, 1)).astype(np.float32))
    ref = spec.apply(variables, x, train=True)
    got = pspec.apply(variables, x, train=True)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_stage_b_group_equals_split(rng):
    """The grouped stage-B formulation (packed-domain feature-group
    convs) == the parity-batched split formulation, including dilation-4
    layers (cell dilation 2)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flypylib_tpu.models.zoo import baseline_model, vgg_like
    from flypylib_tpu.ops.packed_conv import packed_spec

    for mk in (
        lambda: baseline_model(features=(4, 6, 8), dilations=(1, 2, 2),
                               head_features=8, dtype=jnp.float32),
        lambda: vgg_like(features=(4, 6, 8), dilations=(1, 2, 4),
                         head_features=8, dtype=jnp.float32),
    ):
        spec = mk()
        g = packed_spec(spec, stage_b="group")
        s = packed_spec(spec, stage_b="split")
        # the split engine's size constraints are stricter (dilation-4
        # needs two pack levels); pick a size valid for both
        sz = s.valid_size(max(g.min_size, s.min_size) + 16)
        assert g.is_valid_size(sz)
        variables = spec.init(jax.random.PRNGKey(0), sz)
        x = jnp.asarray(rng.random((1, sz, sz, sz, 1)), jnp.float32)
        out_g = np.asarray(g.module.apply(variables, x, train=False))
        out_s = np.asarray(s.module.apply(variables, x, train=False))
        np.testing.assert_allclose(out_g, out_s, rtol=1e-5, atol=1e-6)
        plain = np.asarray(spec.module.apply(variables, x, train=False))
        np.testing.assert_allclose(out_g, plain, rtol=1e-4, atol=1e-5)


def test_two_phase_apply_equals_forward(rng):
    """apply_stage_b(apply_stage_a(x)) == the monolithic packed apply,
    bitwise — the phase boundary re-associates nothing."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flypylib_tpu.models.zoo import baseline_model, vgg_like
    from flypylib_tpu.ops.packed_conv import packed_spec

    for mk in (
        lambda: baseline_model(features=(4, 6), dilations=(1, 2),
                               head_features=8, dtype=jnp.float32),
        lambda: vgg_like(features=(4, 6, 8), dilations=(1, 2, 4),
                         head_features=8, dtype=jnp.float32),
    ):
        spec = mk()
        ps = packed_spec(spec, stage_b="split")
        sz = ps.valid_size(ps.min_size + 8)
        variables = spec.init(jax.random.PRNGKey(0), sz)
        x = jnp.asarray(rng.random((1, sz, sz, sz, 1)), jnp.float32)
        mono = np.asarray(ps.module.apply(variables, x, train=False))
        xa = ps.module.apply_stage_a(variables, x)
        two = np.asarray(ps.module.apply_stage_b(variables, xa))
        np.testing.assert_array_equal(two, mono)


def test_pipeline_two_phase_equals_fused(rng):
    """DetectPipeline's two-phase slab forward == the fused forward —
    identical prob maps and detections on both transports."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flypylib_tpu.infer.pipeline import DetectPipeline
    from flypylib_tpu.models.zoo import baseline_model
    from flypylib_tpu.ops.packed_conv import packed_spec

    spec = baseline_model(features=(4, 6), dilations=(1, 2),
                          head_features=8, dtype=jnp.float32)
    ps = packed_spec(spec)
    variables = spec.init(jax.random.PRNGKey(0), 16)
    vol = (rng.random((36, 30, 30)) * 255).astype(np.uint8)
    kw = dict(tile_out=12, tile_batch=2, window=5, threshold=0.6)
    pipe2 = DetectPipeline(ps, variables, vol.shape, **kw)
    pipe1 = DetectPipeline(ps, variables, vol.shape, two_phase=False,
                           **kw)
    assert pipe2.two_phase and not pipe1.two_phase
    # staged-slab transport
    out2 = np.asarray(pipe2.forward(vol))
    out1 = np.asarray(pipe1.forward(vol))
    np.testing.assert_allclose(out2, out1, rtol=1e-6, atol=1e-7)
    # device-resident transport (forward_from, traced origin)
    big2 = pipe2.stage_full(vol)
    big1 = pipe1.stage_full(vol)
    f2 = np.asarray(pipe2.forward_full(big2))
    f1 = np.asarray(pipe1.forward_full(big1))
    np.testing.assert_allclose(f2, f1, rtol=1e-6, atol=1e-7)
    d2 = pipe2.postprocess(pipe2.forward(vol))
    d1 = pipe1.postprocess(pipe1.forward(vol))
    np.testing.assert_array_equal(d2[0].locs, d1[0].locs)


def test_forward_train_matches_plain_and_grads(rng):
    """The differentiable packed forward (forward_train): same values
    and same gradients as the plain ConvStack train forward, to
    accumulation tolerance (it is an exact linear re-association; only
    bf16 rounding order differs — here f32 makes it tight)."""
    spec = baseline_model(
        features=(4, 6), dilations=(1, 2), head_features=8,
        dtype=jnp.float32,
    )
    pspec = packed_spec(spec)
    s = pspec.valid_size(max(pspec.min_size, 14))
    variables = spec.init(jax.random.PRNGKey(0), s)
    x = jnp.asarray(rng.normal(size=(2, s, s, s, 1)).astype(np.float32))

    ref = spec.apply(variables, x, train=True)
    got = pspec.module.forward_train(variables, x)
    np.testing.assert_allclose(
        np.asarray(ref), np.asarray(got), rtol=1e-5, atol=1e-5
    )

    def loss_plain(p):
        return jnp.mean(spec.apply({"params": p}, x, train=True) ** 2)

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


def test_forward_train_rejections(rng):
    """BatchNorm models and group-mode stage B refuse packed training."""
    bn_module = ConvStack(
        features=(4,), dilations=(1,), head_features=4,
        dtype=jnp.float32, use_batchnorm=True,
    )
    pbn = PackedConvStack(bn_module)
    s = 8
    variables = bn_module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, s, s, s, 1)), train=False
    )
    x = jnp.zeros((1, s, s, s, 1), jnp.float32)
    with pytest.raises(ValueError, match="use_batchnorm"):
        pbn.forward_train(variables, x)

    g = packed_spec(
        baseline_model(features=(4, 6), dilations=(1, 2),
                       head_features=4, dtype=jnp.float32),
        stage_b="group",
    )
    sg = g.valid_size(g.min_size)
    vg = g.module.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, sg, sg, sg, 1)))
    with pytest.raises(ValueError, match="split"):
        g.module.forward_train(vg, jnp.zeros((1, sg, sg, sg, 1)))


def test_pack_parity_vjps_are_inverse_permutations():
    """The hand-written VJPs (round 5): the cotangent of each pack /
    parity permutation is EXACTLY the inverse permutation applied to
    the incoming cotangent — bitwise, not just numerically."""
    import jax

    from flypylib_tpu.ops.packed_conv import (
        pack_volume,
        pack_volume_iv,
        parity_batch,
        parity_merge,
        parity_split,
        unpack_volume,
        unpack_volume_iv,
    )

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 4, 6, 8, 3)), jnp.float32)
    pairs = [
        (pack_volume, unpack_volume, x),
        (pack_volume_iv, unpack_volume_iv, x),
        (unpack_volume, pack_volume, pack_volume(x)),
        (unpack_volume_iv, pack_volume_iv, pack_volume(x)),
        (parity_split, parity_merge, x[..., :1]),
        (parity_merge, parity_split, parity_split(x[..., :1])),
        (parity_batch, None, pack_volume(x)),
    ]
    for fwd, inv, xin in pairs:
        y, vjp = jax.vjp(fwd, xin)
        g = jnp.asarray(rng.standard_normal(y.shape), jnp.float32)
        (gx,) = vjp(g)
        assert gx.shape == xin.shape
        if inv is not None:
            np.testing.assert_array_equal(np.asarray(gx),
                                          np.asarray(inv(g)))
        # permutation check: the cotangent is the same multiset of
        # values, and round-tripping recovers g exactly
        np.testing.assert_array_equal(
            np.sort(np.asarray(gx).ravel()), np.sort(np.asarray(g).ravel())
        )
        np.testing.assert_array_equal(np.asarray(fwd(gx)), np.asarray(g))
