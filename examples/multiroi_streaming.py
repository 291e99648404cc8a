"""Multi-ROI streaming demo (eval config 5 [B:11]).

Streams ROIs from a (mock or real) DVID server through the fused detect
pipeline with a resumable work queue; on a multi-chip mesh the same ROIs
can instead go through sharded_infer + sharded_nms (volume sharded over
the devices).  Here the source is synthetic unless --dvid is given.

Run: python examples/multiroi_streaming.py [--roi 64] [--n 4]
     python examples/multiroi_streaming.py --dvid host:port --uuid U --instance grayscale
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np

from flypylib_tpu.infer import DetectPipeline, grid_rois, stream_rois
from flypylib_tpu.infer.roi_queue import dvid_source
from flypylib_tpu.io.dvid import DVIDClient
from flypylib_tpu.models.zoo import baseline_model
from flypylib_tpu.ops.packed_conv import packed_spec
from flypylib_tpu.utils.metrics import MetricsLog


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roi", type=int, default=64)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--dvid", default=None)
    ap.add_argument("--uuid", default=None)
    ap.add_argument("--instance", default="grayscale")
    args = ap.parse_args()

    import jax

    print(f"devices: {jax.devices()}")

    spec = packed_spec(baseline_model())  # packed inference engine
    variables = spec.init(jax.random.PRNGKey(0), 64)
    roi_shape = (args.roi,) * 3
    pipe = DetectPipeline(
        spec, variables, roi_shape, tile_out=args.roi,
        threshold_quantile=1.0 - 500.0 / np.prod(roi_shape),
    )

    if args.dvid:
        client = DVIDClient(args.dvid, args.uuid)
        source = dvid_source(client, args.instance)
        rois = grid_rois((args.roi * args.n, args.roi, args.roi), args.roi)
    else:
        rng = np.random.default_rng(0)
        big = rng.integers(0, 256,
                           (args.roi * args.n, args.roi, args.roi)
                           ).astype(np.uint8)

        def source(roi):
            sl = tuple(slice(o, o + s) for o, s in zip(roi.offset, roi.size))
            return big[sl]

        rois = grid_rois(big.shape, args.roi)

    state = tempfile.mktemp(suffix=".json")
    log = MetricsLog()
    results = stream_rois(
        pipe, rois, source, state_path=state,
        progress=lambda r, info: log.log({"roi": r.key, **info}),
    )
    total = sum(len(v) for v in results.values())
    print(f"processed {len(results)} ROIs, {total} detections; "
          f"state at {state}")
    # resume is a no-op
    again = stream_rois(pipe, rois, source, state_path=state)
    print(f"resume check: {len(again)} ROIs re-processed (expected 0)")


if __name__ == "__main__":
    main()
