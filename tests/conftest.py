"""Test configuration: run the suite on a virtual 8-device CPU mesh.

SURVEY.md section 4 item 4: multi-device logic (shard_map halo exchange,
NMS seam merge) is validated on N virtual CPU devices via
``--xla_force_host_platform_device_count``; the same code runs unchanged
on GPUs.  Tests that need a GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them here; ``python chip_smoke.py``
covers that path on the card.
"""

import os

# Force the CPU platform through jax.config before any backend
# initializes (an environment that already imported jax would ignore a
# late JAX_PLATFORMS).  XLA_FLAGS is read at (lazy) CPU client init,
# which hasn't happened yet at conftest import.
xla_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

# persistent compilation cache: the suite's CPU executables are
# identical across runs, so cache hits cut repeat-suite wall-clock.
# Keyed on HLO + jaxlib fingerprint, so stale hits are not a correctness
# risk.
from flypylib_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: tests marked ``gpu`` decide here, at
    run time, so every xdist worker collects the same tests."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run python chip_smoke.py on the card)")
    return gpus[0]


def make_blob_volume(shape=(48, 48, 48), centers=None, sigma=2.5, rng=None):
    """Synthetic probability-like volume: Gaussian blobs at given centers."""
    shape = tuple(shape)
    if centers is None:
        centers = [(12, 12, 12), (30, 35, 20), (40, 10, 40)]
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    vol = np.zeros(shape, dtype=np.float32)
    for c in centers:
        d2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        vol = np.maximum(vol, np.exp(-d2 / (2 * sigma**2)).astype(np.float32))
    return vol, np.asarray(centers, dtype=np.float64)


@pytest.fixture
def blob_volume():
    return make_blob_volume()


# ---------------------------------------------------------------------------
# Fast tier: `pytest -m "not slow"` keeps a time-budgeted run clear of
# the cold-cache compile wall; the full suite is dominated by the entries
# below.
# Centralized nodeid-prefix list instead of per-file decorators so the
# tier can be retuned from one place against `--durations` data.
_SLOW_NODEIDS = [
    # module-scoped trained-network fixture (~350 s setup) + its users
    "test_network_api.py::test_train_decreases_loss",
    "test_network_api.py::test_infer_and_detect",
    "test_network_api.py::test_nms_components_verbs",
    "test_network_api.py::test_checkpoint_roundtrip",
    "test_network_api.py::test_evaluate_on_prob_map",
    "test_network_api.py::test_detect_large_verb",
    "test_network_api.py::test_unet_train_smoke",
    "test_network_api.py::test_model_zoo_names",
    "test_train.py::test_loss_decreases",
    "test_train.py::test_validation_uses_infer_engine_tiling",
    "test_train.py::test_packed_engine_matches_plain",
    "test_train.py::test_uint8_image_training",
    "test_packed_conv.py::test_stage_b_group_equals_split",
    # zoo width only; the tiny-width cases stay in the fast tier
    "test_packed_conv.py::test_packed_apply_matches_convstack[baseline]",
    "test_packed_conv.py::test_forward_train_matches_plain_and_grads",
    "test_packed_conv.py::test_packed_spec_rejects_unet",
    "test_packed_conv.py::test_packed_spec_geometry_and_tiling",
    "test_infer_tiled.py::test_default_tiling_regimes",
    "test_infer_tiled.py::test_infer_uint8_wire_bitwise",
    "test_infer_tiled.py::test_tiled_unet",
    "test_infer_tiled.py::test_network_default_tiling_matches_explicit",
    "test_distributed.py::test_two_process_distributed_cpu",
    "test_property_fuzz.py::test_components_fuzz",
    "test_property_fuzz.py::test_sharded_components_2d_fuzz",
    "test_property_fuzz.py::test_nms_fuzz",
    "test_property_fuzz.py::test_streaming_components_fuzz",
    "test_property_fuzz.py::test_sharded_nms_2d_fuzz",
    "test_property_fuzz.py::test_shared_forward_tile_fuzz",
    "test_large.py::test_staged_chunked_bit_identical",
    "test_large.py::test_staged_shared_multi_device_pooled",
    "test_network_api.py::test_detect_large_devices_passthrough",
    "test_packed_conv.py::test_packed_pipeline_detections",
    "test_packed_conv.py::test_two_phase_apply_equals_forward",
    "test_packed_conv.py::test_forward_train_rejections",
    "test_metrics_and_import.py::test_keras_order_import_rejects_unet",
    "test_large.py::test_staged_shared_anisotropic_core_and_edges",
    "test_large.py::test_pooled_default_core_and_tile",
    "test_large.py::test_staged_shared_forward_pooled",
    "test_large.py::test_streaming_multi_device_pooled",
    "test_large.py::test_streaming_multi_device",
    "test_large.py::test_staged_shared_forward_multi_device",
    "test_large.py::test_streaming_shared_pooled",
    "test_detect_ops.py::test_compact_true_indices_matches_nonzero",
    "test_metrics_and_import.py::test_keras_unet_roundtrip",
    "test_parallel.py::test_dp_train_step_matches_single_chip",
    "test_parallel.py::test_dp_train_step_loss_decreases",
    "test_matching.py::test_voxel_pr_streaming_matches_monolithic",
    "test_matching.py::test_match_detections_large_uses_kdtree",
]


def _is_slow(nodeid: str) -> bool:
    # Trailing-"::" entries mark a whole file; otherwise match the exact
    # test or its parametrizations only (a bare prefix match would also
    # capture e.g. test_loss_decreases_fast).
    for pfx in _SLOW_NODEIDS:
        if pfx.endswith("::"):
            if nodeid.startswith(pfx):
                return True
        elif nodeid == pfx or nodeid.startswith(pfx + "["):
            return True
    return False


def pytest_collection_modifyitems(config, items):
    for item in items:
        nodeid = item.nodeid.replace("tests/", "", 1)
        if _is_slow(nodeid):
            item.add_marker(pytest.mark.slow)
