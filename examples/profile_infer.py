"""Profiling demo: per-stage timers + an XLA trace for Perfetto.

Shows the observability layer (SURVEY.md section 5): StageTimer Mvox/s
counters around each pipeline stage and a jax.profiler trace you can load
in Perfetto / TensorBoard.

Run: python examples/profile_infer.py [--size 128] [--trace /tmp/trace]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from flypylib_tpu.infer.pipeline import DetectPipeline
from flypylib_tpu.models.zoo import baseline_model
from flypylib_tpu.ops.packed_conv import packed_spec
from flypylib_tpu.utils.metrics import StageTimer, profile_trace


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    import jax

    print(f"devices: {jax.devices()}")
    spec = packed_spec(baseline_model())  # packed inference engine
    variables = spec.init(jax.random.PRNGKey(0), 64)
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 256, (args.size,) * 3).astype(np.uint8)

    pipe = DetectPipeline(
        spec, variables, vol.shape, tile_out=min(args.size, 128),
        threshold_quantile=1.0 - 2000.0 / vol.size,
    )
    timer = StageTimer()
    with timer.stage("compile+first_run", voxels=vol.size):
        pipe(vol)
    for _ in range(3):
        with timer.stage("detect_pipeline", voxels=vol.size):
            nms_det, cc_det = pipe(vol)
    if args.trace:
        with profile_trace(args.trace):
            pipe(vol)
        print(f"trace written to {args.trace}")
    print(json.dumps(timer.report()))
    print(f"detections: nms={len(nms_det)} cc={len(cc_det)}")


if __name__ == "__main__":
    main()
