"""End-to-end demo: train -> infer -> nms -> evaluate on a synthetic cutout.

Parity: flypylib's examples/ scripts (SURVEY.md section 2.2 row 7) which
download a labeled FIB-SEM cutout, build label/mask volumes, train a net,
infer on held-out data, and report a PR curve.  Nothing is downloaded here,
so the cutout is synthetic: Gaussian-blob "T-bars" on noise, with the same
JSON annotation round-trip the real pipeline uses.

Run: python examples/train_infer_eval.py [--size 64] [--epochs 3]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np

import flypylib_tpu as fpl
from flypylib_tpu.io.synapses import Tbars, load_from_json, save_to_json
from flypylib_tpu.train.trainer import TrainConfig


def synthetic_cutout(size: int, n_pts: int, seed: int):
    rng = np.random.default_rng(seed)
    centers = rng.integers(10, size - 10, (n_pts, 3)).astype(np.float64)
    zz, yy, xx = np.meshgrid(*[np.arange(size)] * 3, indexing="ij")
    image = np.zeros((size,) * 3, dtype=np.float32)
    for c in centers:
        d2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        image = np.maximum(image, np.exp(-d2 / (2 * 2.5**2)).astype(np.float32))
    image += rng.normal(0, 0.05, image.shape).astype(np.float32)
    return image, Tbars(locs=centers)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--model", default="baseline")
    args = ap.parse_args()

    import jax

    print(f"devices: {jax.devices()}")

    # --- data: synthetic cutout + JSON annotation round-trip --------------
    train_img, train_tb = synthetic_cutout(args.size, 8, seed=0)
    test_img, test_tb = synthetic_cutout(args.size, 8, seed=1)
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(save_to_json(test_tb), f)
        gt_path = f.name
    test_gt = load_from_json(gt_path)

    # --- train ------------------------------------------------------------
    net = fpl.FplNetwork(
        args.model,
        train_config=TrainConfig(
            patch_size=25, batch_size=32, steps_per_epoch=60,
            learning_rate=5e-4,
        ),
    )
    t0 = time.time()
    hist = net.train(train_img, tbars=train_tb, epochs=args.epochs, radius=3)
    print(f"train: {time.time() - t0:.1f}s  "
          + " ".join(f"epoch{h['epoch']} loss={h['loss']:.4f}" for h in hist))

    # --- infer ------------------------------------------------------------
    t0 = time.time()
    prob = net.infer(test_img, tile_out=32, tile_batch=2)
    dt = time.time() - t0
    mvox = test_img.size / dt / 1e6
    print(f"infer: {dt:.2f}s ({mvox:.1f} Mvox/s)  prob range "
          f"[{prob.min():.3f}, {prob.max():.3f}]")

    # --- nms + evaluate ---------------------------------------------------
    det = fpl.nms(prob, window=5, threshold=0.5)
    print(f"nms: {len(det)} detections (gt has {len(test_gt)})")
    curve = fpl.evaluate(det, test_gt, dist_thresh=5.0)
    if len(curve["precision"]):
        print(f"evaluate: precision={curve['precision'][-1]:.3f} "
              f"recall={curve['recall'][-1]:.3f} at conf>="
              f"{curve['conf'][-1]:.3f}")
    else:
        print("evaluate: no detections")

    # --- detect in one pass (prob map stays in HBM) -----------------------
    det2 = net.detect(test_img, window=5, threshold=0.5, tile_out=32,
                      tile_batch=2)
    assert len(det2) == len(det), (len(det2), len(det))
    print("detect (on-device pipeline) matches infer+nms:", len(det2))


if __name__ == "__main__":
    main()
