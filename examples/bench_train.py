"""Training-loop throughput benchmark (eval config 3 [B:9]).

Measures steady-state steps/sec and patch-Mvox/sec of the single-dispatch
scanned train step — on-device sampling + flip/rot augmentation + fwd/bwd
+ Adam — and the augmentation overhead (augment on vs off), demonstrating
that augmentation is fused into the step (no separate host pass, ~zero
marginal cost).

Run: python examples/bench_train.py [--steps 200] [--batch 32] [--patch 33]
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np

from flypylib_tpu.models.zoo import baseline_model
from flypylib_tpu.train.trainer import (
    TrainConfig,
    TrainData,
    Trainer,
    make_train_step,
)


def measure(cfg, spec, data, steps):
    tr = Trainer(spec, cfg, seed=0)
    state = tr.init_state()
    _, epoch_step, patch = make_train_step(spec, cfg)
    keys = jax.random.split(jax.random.PRNGKey(1), steps)
    state, m = epoch_step(state, keys, data)  # compile + warm
    float(m["loss"])
    t0 = time.perf_counter()
    state, m = epoch_step(state, keys, data)
    float(m["loss"])
    dt = time.perf_counter() - t0
    return dt, patch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--patch", type=int, default=33)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--engine", default="plain", choices=("plain", "packed"),
                    help="'packed' differentiates the space-to-depth "
                    "engine's forward")
    args = ap.parse_args()

    print(f"devices: {jax.devices()}")
    spec = baseline_model()
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (args.size,) * 3).astype(np.uint8)
    labels = (rng.random((args.size,) * 3) > 0.999).astype(np.float32)
    mask = np.ones((args.size,) * 3, np.float32)

    results = {}
    for augment in (True, False):
        cfg = TrainConfig(patch_size=args.patch, batch_size=args.batch,
                          augment=augment, steps_per_epoch=args.steps,
                          engine=args.engine)
        _, _, patch = make_train_step(spec, cfg)
        data = TrainData.build(image, labels, mask, patch)
        dt, patch = measure(cfg, spec, data, args.steps)
        sps = args.steps / dt
        mvox = args.steps * args.batch * patch**3 / dt / 1e6
        results["augment_on" if augment else "augment_off"] = {
            "steps_per_s": round(sps, 1),
            "patch_mvox_per_s": round(mvox, 1),
            "seconds": round(dt, 3),
        }
    on, off = results["augment_on"], results["augment_off"]
    results["augment_overhead_pct"] = round(
        100.0 * (off["steps_per_s"] / on["steps_per_s"] - 1.0), 1
    )
    print(json.dumps(results))


if __name__ == "__main__":
    main()
