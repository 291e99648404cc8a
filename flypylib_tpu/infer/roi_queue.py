"""Resumable multi-ROI streaming inference (eval config 5 [B:11]).

Parity/aux subsystem (SURVEY.md section 5): flypylib had no failure
recovery; long multi-ROI DVID runs here get a persistent work queue — one
JSON state file, one entry per ROI (pending/done, detection counts) — so a
killed job resumes where it stopped.  ROI volumes are prefetched on a
background thread (network/disk rides under device compute), pushed through a
``DetectPipeline`` (one upload + one dispatch per ROI; uniform ROI shapes
share one compile), deduplicated by ROI ownership where fetch boxes
overlap, and detections can be pushed back to DVID as annotation
elements.  Each ROI is processed independently (reflect-padded at its own
borders, flypylib block style); for bit-exact whole-volume NMS semantics
across ROI seams use flypylib_tpu.infer.large instead.

Sources/sinks are callables so HDF5, DVID, or synthetic backends plug in:
``source(roi) -> (z,y,x) array``, ``sink(roi, tbars) -> None``.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from dataclasses import dataclass

import numpy as np

from flypylib_tpu.io.synapses import Tbars


@dataclass(frozen=True)
class ROI:
    """offset/size in (z, y, x) voxels.

    ``own_offset``/``own_size`` optionally define the sub-box this ROI
    *owns* when fetch boxes overlap (grid_rois shifts edge ROIs inward to
    keep shapes uniform): detections outside the owned box are dropped so
    overlapping ROIs never double-report a synapse.  Default: the full ROI.
    """

    offset: tuple[int, int, int]
    size: tuple[int, int, int]
    own_offset: tuple[int, int, int] | None = None
    own_size: tuple[int, int, int] | None = None

    @property
    def key(self) -> str:
        return "{}_{}_{}__{}_{}_{}".format(*self.offset, *self.size)

    def owned(self) -> tuple[np.ndarray, np.ndarray]:
        """(lo, hi) of the owned box in global coords."""
        lo = np.asarray(self.own_offset
                        if self.own_offset is not None else self.offset)
        size = np.asarray(self.own_size
                          if self.own_size is not None else self.size)
        return lo, lo + size


def dvid_source(client, instance: str):
    """Source adapter: fetch grayscale cutouts from DVID."""

    def fetch(roi: ROI) -> np.ndarray:
        return client.get_gray3d(instance, roi.size, roi.offset)

    return fetch


def dvid_sink(client, instance: str):
    """Sink adapter: push detections (shifted to global coords) to DVID."""

    def push(roi: ROI, tbars: Tbars) -> None:
        global_tb = Tbars(
            locs=tbars.locs + np.asarray(roi.offset, dtype=np.float64),
            conf=tbars.conf,
        )
        client.post_annotations(instance, global_tb)

    return push


class ROIQueue:
    """Persistent work queue over ROIs with crash-safe resume."""

    def __init__(self, rois: list[ROI], state_path: str | None = None):
        self.rois = list(rois)
        self.state_path = state_path
        self.state: dict[str, dict] = {}
        if state_path and os.path.exists(state_path):
            with open(state_path) as f:
                self.state = json.load(f)

    def pending(self) -> list[ROI]:
        return [
            r for r in self.rois
            if self.state.get(r.key, {}).get("status") != "done"
        ]

    def mark_done(self, roi: ROI, info: dict) -> None:
        self.state[roi.key] = {"status": "done", **info}
        self._persist()

    def _persist(self) -> None:
        if not self.state_path:
            return
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state, f)
        os.replace(tmp, self.state_path)  # atomic


def stream_rois(
    pipeline,
    rois: list[ROI],
    source,
    sink=None,
    state_path: str | None = None,
    prefetch: int = 2,
    progress=None,
):
    """Run the detect pipeline over every pending ROI, resumably.

    ``pipeline``: a ``DetectPipeline`` built for the (uniform) ROI shape —
    or any callable ``(volume) -> (nms Tbars, cc Tbars|None)``.
    Returns ``{roi.key: nms Tbars}`` for the ROIs processed this call.
    """
    q = ROIQueue(rois, state_path)
    todo = q.pending()
    results: dict[str, Tbars] = {}
    if not todo:
        return results

    fetched: queue.Queue = queue.Queue(maxsize=prefetch)

    def fetcher():
        for roi in todo:
            try:
                fetched.put((roi, source(roi), None))
            except Exception as e:  # surface fetch errors on the main thread
                fetched.put((roi, None, e))

    t = threading.Thread(target=fetcher, daemon=True)
    t.start()

    for _ in todo:
        roi, vol, err = fetched.get()
        if err is not None:
            raise RuntimeError(f"ROI {roi.key}: fetch failed") from err
        t0 = time.perf_counter()
        nms_det, cc_det = pipeline(vol)
        dt = time.perf_counter() - t0

        def filter_owned(det):
            if det is None or len(det) == 0:
                return det
            lo, hi = roi.owned()
            local_lo = lo - np.asarray(roi.offset)
            local_hi = hi - np.asarray(roi.offset)
            keep = np.all(
                (det.locs >= local_lo) & (det.locs < local_hi), axis=1
            )
            return Tbars(locs=det.locs[keep], conf=det.conf[keep])

        nms_det = filter_owned(nms_det)
        cc_det = filter_owned(cc_det)
        if sink is not None:
            sink(roi, nms_det)
        info = {
            "nms_detections": len(nms_det),
            "cc_components": len(cc_det) if cc_det is not None else None,
            "seconds": round(dt, 4),
            "mvox_per_s": round(int(np.prod(roi.size)) / dt / 1e6, 3),
        }
        q.mark_done(roi, info)
        results[roi.key] = nms_det
        if progress:
            progress(roi, info)
    return results


def grid_rois(volume_size, roi_size, offset=(0, 0, 0)) -> list[ROI]:
    """Cover ``volume_size`` with a grid of equal ROIs (edges clipped to a
    full ROI by shifting the last one inward, flypylib block-math style).

    Each ROI carries its *owned* sub-box — the non-overlapping partition
    cell it is responsible for — so overlapping edge ROIs never
    double-report detections (stream_rois filters by ownership).
    """
    from flypylib_tpu.utils import block_starts, to3d

    vs, rs, off = to3d(volume_size), to3d(roi_size), to3d(offset)
    size = tuple(min(r, v) for v, r in zip(vs, rs))
    axes = []
    for v, s in zip(vs, size):
        starts = block_starts(v, s)
        ends = starts[1:] + [v]  # ownership partition boundaries
        axes.append(list(zip(starts, ends)))
    return [
        ROI(
            offset=(off[0] + z0, off[1] + y0, off[2] + x0),
            size=size,
            own_offset=(off[0] + z0, off[1] + y0, off[2] + x0),
            own_size=(ze - z0, ye - y0, xe - x0),
        )
        for (z0, ze) in axes[0]
        for (y0, ye) in axes[1]
        for (x0, xe) in axes[2]
    ]
