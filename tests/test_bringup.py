"""Platform plumbing: the compile-cache location, the one device-memory
budget and each caller's ``bytes_limit=``, imports without the optional
packages, the train-state pytrees, multi-process bring-up, and the GPU
entry points refusing to run without a GPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra=None, drop=(), cwd=REPO, args=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-c", code, *args], capture_output=True, text=True,
        timeout=300, env=env, cwd=cwd,
    )


# -- compile cache ------------------------------------------------------------

_CACHE_PROBE = (
    "import sys, jax\n"
    "from flypylib_tpu.utils.cache import enable_compilation_cache\n"
    "arg = sys.argv[1] if len(sys.argv) > 1 else None\n"
    "path = enable_compilation_cache(arg, min_compile_time_secs=0.0)\n"
    "print(path)\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


def test_cache_env_var_wins(tmp_path):
    env_dir = str(tmp_path / "from_env")
    out = _run(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": env_dir})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [env_dir, env_dir]


def test_cache_env_var_not_overridden_by_caller(tmp_path):
    """With the env var set, a caller's path is ignored and never
    created: the program keeps its cache in one directory only."""
    env_dir = str(tmp_path / "from_env")
    mine = tmp_path / "caller"
    out = _run(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": env_dir},
               args=(str(mine),))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [env_dir, env_dir]
    assert not mine.exists()


def test_cache_default_is_fixed_in_checkout(tmp_path):
    from flypylib_tpu.utils.cache import DEFAULT_CACHE_DIR

    out = _run(_CACHE_PROBE, drop=("JAX_COMPILATION_CACHE_DIR",),
               cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [DEFAULT_CACHE_DIR, DEFAULT_CACHE_DIR]
    assert DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# -- the device-memory budget -------------------------------------------------


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        if isinstance(self._stats, Exception):
            raise self._stats
        return self._stats


def test_device_bytes_limit_reads_bytes_limit():
    from flypylib_tpu.utils.memory import device_bytes_limit

    dev = _FakeDevice({"bytes_limit": 60 << 30, "bytes_in_use": 1})
    assert device_bytes_limit(dev) == 60 << 30


@pytest.mark.parametrize("stats", [None, {}, RuntimeError("no stats")])
def test_device_bytes_limit_falls_back_to_host_memory(stats):
    from flypylib_tpu.utils.memory import device_bytes_limit, host_memory_bytes

    host = host_memory_bytes()
    assert host == os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert device_bytes_limit(_FakeDevice(stats)) == host
    # the CPU backend reports no allocator limit: the host's RAM it is
    assert device_bytes_limit() == host


def test_staged_cutoff_default_reads_the_helper(monkeypatch):
    import flypylib_tpu.utils.memory as mem
    from flypylib_tpu.network import _staged_fits_hbm

    vol = np.zeros((8, 8, 8), np.uint8)  # 512 B + 2 KiB shell
    monkeypatch.setattr(mem, "device_bytes_limit", lambda device=None: 10)
    assert not _staged_fits_hbm(vol)
    monkeypatch.setattr(mem, "device_bytes_limit",
                        lambda device=None: 1 << 20)
    assert _staged_fits_hbm(vol)
    assert not _staged_fits_hbm(vol, bytes_limit=100)


def _tiny_plan(shape=(24, 24, 24)):
    from flypylib_tpu.infer.large import make_stream_plan
    from flypylib_tpu.models.zoo import baseline_model

    spec = baseline_model(features=(4,), dilations=(1,), head_features=4,
                          dtype=jnp.float32)
    variables = spec.init(jax.random.PRNGKey(0), 16)
    return make_stream_plan(spec, variables, shape, core=12, window=3,
                            threshold=0.5)


def test_shared_auto_honours_bytes_limit():
    plan = _tiny_plan()
    staged = 24 ** 3
    assert plan.shared_auto(staged, bytes_limit=64 << 30)
    assert not plan.shared_auto(staged, bytes_limit=1 << 30)


def test_band_rpb_honours_bytes_limit():
    plan = _tiny_plan()
    assert plan.band_rpb(itemsize=1, cost_gate=False,
                         bytes_limit=64 << 30) is not None
    assert plan.band_rpb(itemsize=1, cost_gate=False,
                         bytes_limit=1 << 30) is None


def test_evaluate_voxels_cutoff_honours_bytes_limit(monkeypatch, rng):
    """The on-device voxel-PR path is taken when 16 bytes a voxel fit a
    quarter of the budget, else the streaming path — same numbers."""
    import flypylib_tpu.ops.matching as matching
    from flypylib_tpu.network import FplNetwork

    net = FplNetwork("baseline", features=(4,), dilations=(1,),
                     head_features=4, packed=False)
    shape = (12, 12, 12)
    vol = rng.random(shape).astype(np.float32)
    labels = (rng.random(shape) > 0.9).astype(np.float32)
    calls = []
    for name in ("voxel_pr_device", "voxel_pr_streaming"):
        real = getattr(matching, name)
        monkeypatch.setattr(
            matching, name,
            lambda *a, _n=name, _r=real, **k: calls.append(_n) or _r(*a, **k),
        )
    big = net.evaluate_voxels(vol, labels, bytes_limit=1 << 30)
    small = net.evaluate_voxels(vol, labels, bytes_limit=16 * vol.size)
    assert calls == ["voxel_pr_device", "voxel_pr_streaming"]
    np.testing.assert_array_equal(big["precision"], small["precision"])
    np.testing.assert_array_equal(big["recall"], small["recall"])


# -- imports without the optional packages --------------------------------------

_BLOCKED_IMPORT = """
import sys
for name in ("flax", "h5py", "orbax", "orbax.checkpoint"):
    sys.modules[name] = None  # any import of them now raises ImportError
import jax, jax.numpy as jnp
import flypylib_tpu
from flypylib_tpu import FplNetwork
from flypylib_tpu.io import read_h5  # noqa: F401  (lazy h5py)
import flypylib_tpu.io.keras_import  # noqa: F401
import flypylib_tpu.parallel, flypylib_tpu.infer.large  # noqa: F401
net = FplNetwork("unet", seed=0)
s = net.spec.min_size
out = net.spec.apply(net.variables, jnp.zeros((1, s, s, s, 1)))
assert out.shape == (1, s - 2 * net.context, s - 2 * net.context,
                     s - 2 * net.context, 1), out.shape
assert not any(m.split(".")[0] in ("flax", "h5py", "orbax")
               for m, v in sys.modules.items() if v is not None)
print("ok")
"""


def test_import_and_unet_without_flax_h5py_orbax():
    out = _run(_BLOCKED_IMPORT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


# -- train-state pytrees ---------------------------------------------------------


def test_train_state_is_a_pytree_with_static_tx():
    from flypylib_tpu.train.trainer import TrainState

    tx = optax.adam(1e-3)
    st = TrainState.create({"params": {"w": jnp.ones(3)}}, tx)
    leaves, treedef = jax.tree_util.tree_flatten(st)
    # step + param + Adam count/mu/nu; tx is metadata, not a leaf
    assert len(leaves) == 5
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.tx is tx and back.batch_stats == {}
    doubled = jax.tree.map(lambda a: a * 2, st)
    assert isinstance(doubled, TrainState) and doubled.tx is tx


def test_train_state_jit_and_replace():
    from flypylib_tpu.train.trainer import TrainState

    tx = optax.sgd(0.5)
    st = TrainState.create({"params": {"w": jnp.ones(2)}}, tx)

    @jax.jit
    def step(s):
        g = {"w": jnp.ones(2)}
        upd, opt = s.tx.update(g, s.opt_state, s.params)
        return s.replace(step=s.step + 1,
                         params=optax.apply_updates(s.params, upd),
                         opt_state=opt)

    out = step(step(st))
    assert int(out.step) == 2
    np.testing.assert_allclose(out.params["w"], [0.0, 0.0])
    assert int(st.step) == 0  # frozen: replace returned a new state
    with pytest.raises(Exception):
        st.step = 3


def test_train_data_is_a_pytree(rng):
    from flypylib_tpu.train.trainer import TrainData

    vol = rng.random((12, 12, 12)).astype(np.float32)
    lab = (vol > 0.95).astype(np.float32)
    data = TrainData.build(vol, lab, np.ones_like(vol), patch=8)
    assert len(jax.tree_util.tree_leaves(data)) == 6
    n = jax.jit(lambda d: d.n_pos + d.images.shape[0])(data)
    assert int(n) == int(data.n_pos) + 1
    assert data.replace(n_pos=jnp.int32(0)).n_pos == 0


# -- multi-process bring-up ------------------------------------------------------


def test_ensure_initialized_single_process_is_noop(monkeypatch):
    import flypylib_tpu.parallel.distributed as dist

    for k in ("COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(dist, "_initialized", False)
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **k: pytest.fail("must not initialize"))
    assert dist.ensure_initialized() is False


def test_ensure_initialized_passes_the_env_coordinator(monkeypatch):
    import flypylib_tpu.parallel.distributed as dist

    seen = {}
    monkeypatch.setattr(dist, "_initialized", False)
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **k: seen.update(k))
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:12355")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    assert dist.ensure_initialized() is True
    assert seen == {"coordinator_address": "localhost:12355",
                    "num_processes": 2, "process_id": 1}
    monkeypatch.setattr(dist, "_initialized", False)


# -- GPU entry points ------------------------------------------------------------


def test_chip_smoke_refuses_without_gpu():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        timeout=300, cwd=str(tmp_path), env=env,
    )
    assert out.returncode != 0
    assert "checkout" in out.stderr
    assert out.stdout == ""


def test_bench_refuses_without_gpu():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr


@pytest.mark.gpu
def test_gpu_packed_engine_matches_plain(gpu_device, rng):
    """On the card: the packed conv stack agrees with the plain f32
    model at "highest" precision (chip_smoke.py runs the full-width
    version of this check)."""
    from flypylib_tpu.infer.tiled import TiledInference
    from flypylib_tpu.models.zoo import baseline_model
    from flypylib_tpu.ops.packed_conv import packed_spec

    spec = baseline_model(features=(8, 12), dilations=(1, 2),
                          head_features=8)
    ref_spec = baseline_model(features=(8, 12), dilations=(1, 2),
                              head_features=8, dtype=jnp.float32)
    variables = jax.device_put(spec.init(jax.random.PRNGKey(0), 16),
                               gpu_device)
    vol = rng.random((40, 40, 40)).astype(np.float32)
    got = TiledInference(packed_spec(spec), variables, tile_out=16).infer(vol)
    with jax.default_matmul_precision("highest"):
        ref = TiledInference(ref_spec, variables, tile_out=16).infer(vol)
    np.testing.assert_allclose(got, ref, atol=2e-2)


@pytest.mark.gpu
def test_gpu_reports_bytes_limit(gpu_device):
    from flypylib_tpu.utils.memory import device_bytes_limit, host_memory_bytes

    limit = device_bytes_limit(gpu_device)
    assert limit == gpu_device.memory_stats()["bytes_limit"]
    assert limit != host_memory_bytes()
