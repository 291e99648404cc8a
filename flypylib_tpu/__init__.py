"""flypylib_tpu — 3D EM-volume synapse detection framework in JAX.

A from-scratch rebuild of the capabilities of janelia-flyem/flypylib
(voxel-wise 3D CNN object detection in FIB-SEM electron-microscopy
volumes: train / infer / nms / evaluate), designed around JAX/XLA rather
than Keras/TensorFlow:

- models: valid-convolution 3D CNNs (baseline conv stack, deeper VGG-like
  stack, 3D U-Net) on a small ``jax.lax`` module layer
  (``models.layers``), each exporting its exact receptive-field
  ``context`` for halo math (parity: flypylib fplmodels).
- ops: on-device non-max suppression (reduce_window max-compare), connected
  components (fixed-point min-label propagation), candidate top-k extraction,
  fused flip/rotation augmentation, plus bit-exact NumPy/SciPy host
  references that define the semantics (parity: flypylib fplobjdetect).
- infer: overlap-tiled fully-convolutional whole-volume inference with
  static tile shapes (single XLA compile) and double-buffered host->device
  feeding (parity: flypylib fplnetwork.infer).
- train: jit train step over randomly sampled, mask-restricted patches with
  on-device augmentation; optax optimizers; orbax checkpoints, an
  optional dependency (parity: flypylib fplnetwork.train).
- parallel: jax.sharding.Mesh data/volume parallelism via shard_map with
  ppermute halo exchange and cross-shard NMS merge (the mesh
  replacement for flypylib multi_gpu.make_parallel).
- io: HDF5 volumes (h5py, an optional dependency), DVID HTTP client,
  T-bar annotation JSON parse and rasterization into label + loss-mask
  volumes (parity: flypylib fplsynapses).

The public API surface preserves flypylib's verbs: ``FplNetwork`` with
``train`` / ``infer`` plus module-level ``nms`` / ``evaluate``.
"""

from flypylib_tpu.network import FplNetwork
from flypylib_tpu.ops.nms import nms
from flypylib_tpu.ops.components import label_components
from flypylib_tpu.ops.matching import (
    evaluate,
    obj_pr,
    obj_pr_curve,
    voxel_pr,
    voxel_pr_device,
    voxel_pr_streaming,
)
from flypylib_tpu.io.synapses import (
    Tbars,
    load_from_json,
    save_to_json,
    tbars_to_volume,
)

# flypylib-style aliases (SURVEY.md section 2.2 row 3 symbol names)
obj_candidates = nms

__version__ = "0.1.0"

__all__ = [
    "FplNetwork",
    "nms",
    "obj_candidates",
    "label_components",
    "evaluate",
    "obj_pr",
    "obj_pr_curve",
    "voxel_pr",
    "voxel_pr_device",
    "voxel_pr_streaming",
    "Tbars",
    "load_from_json",
    "save_to_json",
    "tbars_to_volume",
]
