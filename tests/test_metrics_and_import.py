import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flypylib_tpu.io.keras_import import load_keras_weights, save_keras_weights
from flypylib_tpu.models.zoo import baseline_model
from flypylib_tpu.utils.metrics import (
    MetricsLog,
    StageTimer,
    dump_pr_curve,
    load_pr_curve,
)


def test_stage_timer():
    t = StageTimer()
    with t.stage("infer", voxels=1_000_000):
        pass
    with t.stage("infer", voxels=1_000_000):
        pass
    r = t.report()
    assert r["infer"]["calls"] == 2
    assert r["infer"]["voxels"] == 2_000_000
    assert "mvox_per_s" in r["infer"]


def test_pr_curve_roundtrip(tmp_path):
    curve = {
        "conf": np.array([0.9, 0.8]),
        "precision": np.array([1.0, 0.5]),
        "recall": np.array([0.5, 0.5]),
        "num_gt": np.float64(2),
    }
    for ext in ("json", "csv"):
        p = str(tmp_path / f"curve.{ext}")
        dump_pr_curve(curve, p)
    back = load_pr_curve(str(tmp_path / "curve.json"))
    np.testing.assert_allclose(back["precision"], curve["precision"])
    lines = open(tmp_path / "curve.csv").read().strip().splitlines()
    assert lines[0].split(",")[:1] == ["conf"]
    assert len(lines) == 3


def test_metrics_log(tmp_path):
    p = str(tmp_path / "m.jsonl")
    log = MetricsLog(p)
    log.log({"epoch": 0, "loss": 0.5})
    log.log({"epoch": 1, "loss": 0.4})
    recs = [json.loads(line) for line in open(p)]
    assert len(recs) == 2 and recs[1]["loss"] == 0.4


def test_keras_weight_roundtrip(tmp_path):
    spec = baseline_model(features=(4, 6), dilations=(1, 1), head_features=8,
                          dtype=jnp.float32)
    variables = spec.init(jax.random.PRNGKey(0), 12)
    params = jax.tree.map(np.asarray, variables["params"])
    path = str(tmp_path / "weights.h5")
    save_keras_weights(path, params)

    variables2 = spec.init(jax.random.PRNGKey(1), 12)
    params2 = jax.tree.map(np.asarray, variables2["params"])
    loaded = load_keras_weights(path, params2)
    for name in params:
        np.testing.assert_array_equal(
            loaded[name]["kernel"], params[name]["kernel"]
        )
        np.testing.assert_array_equal(
            loaded[name]["bias"], params[name]["bias"]
        )
    # loaded weights reproduce the original model's output exactly
    x = jnp.asarray(
        np.random.default_rng(0).random((1, 12, 12, 12, 1)).astype(np.float32)
    )
    out1 = spec.apply(variables, x)
    out2 = spec.apply({"params": loaded}, x)
    np.testing.assert_array_equal(np.asarray(out1), np.asarray(out2))


def test_keras_import_shape_mismatch(tmp_path):
    spec = baseline_model(features=(4,), dilations=(1,), head_features=8,
                          dtype=jnp.float32)
    variables = spec.init(jax.random.PRNGKey(0), 12)
    params = jax.tree.map(np.asarray, variables["params"])
    path = str(tmp_path / "w.h5")
    save_keras_weights(path, params)

    spec2 = baseline_model(features=(6,), dilations=(1,), head_features=8,
                           dtype=jnp.float32)
    params2 = jax.tree.map(
        np.asarray, spec2.init(jax.random.PRNGKey(0), 12)["params"]
    )
    with pytest.raises(ValueError, match="shape"):
        load_keras_weights(path, params2)


def test_debug_toggles():
    import jax

    from flypylib_tpu.utils.debug import (
        disable_nan_checks,
        eager_mode,
        enable_nan_checks,
        nan_checks,
    )

    with nan_checks():
        assert jax.config.jax_debug_nans
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: x / 0.0)(jnp.float32(1.0)).block_until_ready()
    assert not jax.config.jax_debug_nans

    with eager_mode():
        # eager: python control flow on traced values works
        def f(x):
            return x + 1 if x > 0 else x - 1

        assert float(f(jnp.float32(2.0))) == 3.0


def test_plot_pr_curve(tmp_path):
    pytest.importorskip("matplotlib")
    from flypylib_tpu.utils.metrics import plot_pr_curve

    curve = {
        "precision": np.array([1.0, 0.9, 0.8]),
        "recall": np.array([0.3, 0.6, 0.9]),
    }
    p = str(tmp_path / "pr.png")
    plot_pr_curve({"run A": curve, "run B": curve}, p)
    import os

    assert os.path.getsize(p) > 1000


def test_keras_unet_roundtrip(tmp_path):
    """U-Net (Conv + ConvTranspose interleaving) round-trips by name."""
    import jax
    import numpy as np

    from flypylib_tpu.io.keras_import import (
        load_keras_variables,
        save_keras_weights,
    )
    from flypylib_tpu.models.zoo import unet

    spec = unet(base_features=4, levels=2, convs_per_stage=1)
    variables = spec.init(jax.random.PRNGKey(3))
    path = str(tmp_path / "unet.h5")
    save_keras_weights(path, variables)

    target = spec.init(jax.random.PRNGKey(9))  # different init
    loaded = load_keras_variables(path, target)
    for k, orig in variables["params"].items():
        for leaf in orig:
            np.testing.assert_array_equal(
                np.asarray(orig[leaf]), np.asarray(loaded["params"][k][leaf])
            )


def test_keras_batchnorm_roundtrip(tmp_path):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flypylib_tpu.io.keras_import import (
        load_keras_variables,
        save_keras_weights,
    )
    from flypylib_tpu.models.zoo import ConvStack

    module = ConvStack(features=(4, 6), dilations=(1, 1), head_features=8,
                       use_batchnorm=True, dtype=jnp.float32)
    variables = module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 12, 12, 12, 1)), train=False
    )
    variables = jax.tree.map(
        lambda v: v + np.random.default_rng(0).normal(
            0, 0.1, v.shape
        ).astype(np.asarray(v).dtype),
        variables,
    )
    path = str(tmp_path / "bn.h5")
    save_keras_weights(path, variables)

    target = module.init(
        jax.random.PRNGKey(4), jnp.zeros((1, 12, 12, 12, 1)), train=False
    )
    loaded = load_keras_variables(path, target)
    for coll in ("params", "batch_stats"):
        for k, orig in variables[coll].items():
            for leaf in orig:
                np.testing.assert_array_equal(
                    np.asarray(orig[leaf]),
                    np.asarray(loaded[coll][k][leaf]),
                )


def test_keras_import_unmatched_layer_errors(tmp_path):
    """Strict contract: missing model layers error, never skip."""
    import jax
    import pytest

    from flypylib_tpu.io.keras_import import (
        load_keras_variables,
        save_keras_weights,
    )
    from flypylib_tpu.models.zoo import baseline_model

    small = baseline_model(features=(4,), dilations=(1,), head_features=8)
    big = baseline_model(features=(4, 6), dilations=(1, 1), head_features=8)
    path = str(tmp_path / "small.h5")
    save_keras_weights(path, small.init(jax.random.PRNGKey(0)))
    with pytest.raises(
        ValueError, match="count mismatch|not present|shape"
    ):
        load_keras_variables(path, big.init(jax.random.PRNGKey(0)))


def test_keras_order_import_rejects_unet(tmp_path):
    """Anonymous (not layer-named) files cannot target U-Nets."""
    import h5py
    import jax
    import numpy as np
    import pytest

    from flypylib_tpu.io.keras_import import load_keras_variables
    from flypylib_tpu.models.zoo import unet

    spec = unet(base_features=4, levels=1, convs_per_stage=1)
    variables = spec.init(jax.random.PRNGKey(0))
    path = str(tmp_path / "anon.h5")
    with h5py.File(path, "w") as f:
        for i in range(3):
            grp = f.create_group(f"conv3d_{i}").create_group(f"conv3d_{i}")
            grp.create_dataset(
                "kernel:0", data=np.zeros((3, 3, 3, 1, 4), np.float32)
            )
            grp.create_dataset("bias:0", data=np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="ConvTranspose"):
        load_keras_variables(path, variables)


def test_enable_compilation_cache(tmp_path):
    """enable_compilation_cache points jax at the dir and executables
    get persisted.  Runs in a subprocess: once this process's
    persistent cache is initialized (the suite's conftest compiles
    against it), a later cache-dir update is ignored by jax — the
    helper is for process start, as its docstring says."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    code = (
        "import sys\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from flypylib_tpu.utils.cache import enable_compilation_cache\n"
        "path = enable_compilation_cache(sys.argv[1],"
        " min_compile_time_secs=0.0)\n"
        "assert jax.config.jax_compilation_cache_dir == path\n"
        "import os\n"
        "import jax.numpy as jnp\n"
        "f = jax.jit(lambda x: jnp.tanh(x @ x.T) * 1.625 - 0.375)\n"
        "f(jnp.arange(36.0).reshape(6, 6)).block_until_ready()\n"
        "print(sum(1 for _ in os.scandir(path)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "xla")],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.strip().splitlines()[-1]) > 0, (
        "no cache entry written"
    )
