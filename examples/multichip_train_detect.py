"""Multi-chip end-to-end: mesh-DP training + multi-device staged detect.

Demonstrates the public multi-chip surface (SURVEY.md section
2.3 DP/SP rows, eval config 5 [B:11]):

- ``FplNetwork.train(..., mesh=...)`` — mesh data-parallel training
  through the public verb (global batch sharded over the ``data`` axis,
  gradient psum across devices; same seed => same params as single-chip).
- ``detect_staged(..., devices=jax.local_devices())`` — the HBM-resident
  ROI sweep round-robined over every local chip, detections
  bit-identical to the single-device sweep.

Runs on real chips or on a virtual CPU mesh:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      JAX_PLATFORMS=cpu python examples/multichip_train_detect.py
"""

from __future__ import annotations

import os
import time

if "host_platform_device_count" in os.environ.get("XLA_FLAGS", ""):
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import numpy as np

from flypylib_tpu.infer.large import detect_staged
from flypylib_tpu.io.synapses import Tbars, make_training_volumes
from flypylib_tpu.network import FplNetwork
from flypylib_tpu.parallel import make_mesh
from flypylib_tpu.train.trainer import TrainConfig


def main():
    devices = jax.devices()
    print(f"devices: {len(devices)} x {devices[0].platform}")
    n_data = max(d for d in (1, 2, 4, 8) if len(devices) % d == 0
                 and d <= len(devices))

    rng = np.random.default_rng(0)
    size = 64
    centers = rng.integers(10, size - 10, (10, 3)).astype(np.float64)
    tbars = Tbars(locs=centers)
    vol = rng.normal(0.1, 0.05, (size,) * 3).astype(np.float32)
    for z, y, x in tbars.locs.astype(int):
        vol[max(0, z - 2): z + 3, max(0, y - 2): y + 3,
            max(0, x - 2): x + 3] += 0.6
    vol = np.clip(vol, 0, 1)
    labels, mask = make_training_volumes(tbars, vol.shape, radius=3.0,
                                         border=6)

    net = FplNetwork(
        "baseline", features=(8, 12), dilations=(1, 2), head_features=16,
        train_config=TrainConfig(patch_size=17, batch_size=4 * n_data,
                                 steps_per_epoch=20, learning_rate=3e-3),
    )
    mesh = make_mesh(n_data, axis="data")
    t0 = time.perf_counter()
    hist = net.train(vol, labels, mask, epochs=3, mesh=mesh)
    print(f"mesh-DP train ({n_data}-way): {time.perf_counter() - t0:.1f}s "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")

    thr = 0.6
    t0 = time.perf_counter()
    det1 = detect_staged(net.infer_spec, net.variables, vol, core=32,
                         window=5, threshold=thr)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    detN = detect_staged(net.infer_spec, net.variables, vol, core=32,
                         window=5, threshold=thr, devices=devices)
    tN = time.perf_counter() - t0
    same = (len(det1) == len(detN)
            and np.array_equal(det1.locs, detN.locs)
            and np.array_equal(det1.conf, detN.conf))
    print(f"detect_staged: single-device {len(det1)} detections "
          f"({t1:.1f}s); {len(devices)}-device {len(detN)} ({tN:.1f}s); "
          f"bit-identical: {same}")
    assert same


if __name__ == "__main__":
    main()
