"""Host-side (NumPy/SciPy) reference implementations of the detection ops.

These pin the exact semantics that the on-device (XLA) versions must
reproduce bit-for-bit at the detection-list level.  Parity: flypylib
fplobjdetect (SURVEY.md section 2.2 row 3, section 3.3): NMS via 3D
max-filter comparison, connected-components labeling via
``scipy.ndimage.label``, centroid extraction.

Pinned semantics (reference unreadable this session; chosen to match the
standard scipy formulation and documented so deviations are auditable):

- NMS candidate: ``prob == maximum_filter(prob, window, constant, -inf)``
  and ``prob >= threshold``.  Out-of-bounds neighbors do not participate
  (equivalent to -inf padding), so edge voxels can be maxima.  Probability
  plateaus produce one candidate per plateau voxel — identical on host and
  device.
- Connected components: 6-connectivity (scipy default
  ``generate_binary_structure(3, 1)``) on ``prob >= threshold``; detection
  location is the component's unweighted voxel centroid; detection
  confidence is the component's max probability.
- Detection ordering: confidence descending; ties broken by (z, y, x)
  ascending of the detection location.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from flypylib_tpu.io.synapses import Tbars
from flypylib_tpu.utils import to3d


def sort_detections(locs: np.ndarray, conf: np.ndarray) -> Tbars:
    """Canonical ordering: conf desc, then (z, y, x) asc. Deterministic."""
    locs = np.asarray(locs, dtype=np.float64).reshape(-1, 3)
    conf = np.asarray(conf, dtype=np.float64).reshape(-1)
    order = np.lexsort((locs[:, 2], locs[:, 1], locs[:, 0], -conf))
    return Tbars(locs=locs[order], conf=conf[order])


def nms_host(prob: np.ndarray, window=3, threshold: float = 0.5) -> Tbars:
    """NMS by max-filter comparison: local-maximum voxels above threshold."""
    prob = np.asarray(prob, dtype=np.float32)
    win = to3d(window)
    mf = ndimage.maximum_filter(prob, size=win, mode="constant", cval=-np.inf)
    cand = (prob == mf) & (prob >= threshold)
    zz, yy, xx = np.nonzero(cand)
    locs = np.stack([zz, yy, xx], axis=1).astype(np.float64)
    return sort_detections(locs, prob[zz, yy, xx])


_STRUCT6 = ndimage.generate_binary_structure(3, 1)


def components_host(prob: np.ndarray, threshold: float = 0.5) -> Tbars:
    """Connected components of the thresholded map -> centroid detections."""
    prob = np.asarray(prob, dtype=np.float32)
    mask = prob >= threshold
    lab, n = ndimage.label(mask, structure=_STRUCT6)
    if n == 0:
        return Tbars(locs=np.zeros((0, 3)), conf=np.zeros((0,)))
    idx = np.arange(1, n + 1)
    centroids = np.asarray(ndimage.center_of_mass(mask, lab, idx))
    conf = ndimage.maximum(prob, lab, idx)
    return sort_detections(centroids, conf)
