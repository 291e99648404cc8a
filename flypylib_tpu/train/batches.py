"""Host-side batch generator — flypylib compatibility shim.

Parity: flypylib fplobjdetect.gen_batches (SURVEY.md section 2.2 row 3):
an infinite generator of augmented (image, label, mask-weight) patch
batches for users who drive their own training loop.  The on-device path
(flypylib_tpu.train.trainer) does all of this on device inside the jit'd
step — this shim exists for API compatibility, custom loops, and as an
independent host-semantics check of the device sampler.

Semantics match the device sampler: corners mix uniform draws with
positive-centered draws (pos_fraction, pos_jitter); augmentation is the
same 16-element group (flypylib_tpu.ops.augment bit layout).
"""

from __future__ import annotations

import numpy as np

from flypylib_tpu.utils import to3d


def _apply_code(patch: np.ndarray, code: int) -> np.ndarray:
    out = patch
    if code & 1:
        out = out[::-1]
    if code & 2:
        out = out[:, ::-1]
    if code & 4:
        out = out[:, :, ::-1]
    if code & 8:
        out = np.swapaxes(out, 1, 2)
    return out


def gen_batches(
    image: np.ndarray,
    labels: np.ndarray,
    mask: np.ndarray,
    patch_size,
    batch_size: int = 32,
    context: int = 0,
    pos_fraction: float = 0.5,
    pos_jitter: int = 5,
    augment: bool = True,
    seed: int = 0,
):
    """Infinite generator of (x, y, m) batches.

    x: (B, p, p, p) float32 patches; y/m: (B, p-2c, p-2c, p-2c) label and
    loss-mask patches center-cropped by ``context`` (the model's
    valid-conv loss region).
    """
    rng = np.random.default_rng(seed)
    image = np.asarray(image)
    labels = np.asarray(labels, np.float32)
    mask = np.asarray(mask, np.float32)
    p = to3d(patch_size)
    if p[1] != p[2] and augment:
        raise ValueError("augmentation requires square (y, x) patches")
    c = context
    out = tuple(s - 2 * c for s in p)
    if min(out) <= 0:
        raise ValueError("patch smaller than 2*context")
    max_corner = np.asarray(image.shape) - p
    if (max_corner < 0).any():
        raise ValueError("volume smaller than patch")
    pos = np.argwhere(labels > 0.5)
    scale = np.float32(1.0 / 255.0) if image.dtype == np.uint8 else None

    while True:
        xs, ys, ms = [], [], []
        for _ in range(batch_size):
            if len(pos) and rng.random() < pos_fraction:
                center = pos[rng.integers(len(pos))] + rng.integers(
                    -pos_jitter, pos_jitter + 1, 3
                )
                corner = np.clip(center - np.asarray(p) // 2, 0, max_corner)
            else:
                corner = rng.integers(0, max_corner + 1)
            sl = tuple(slice(a, a + b) for a, b in zip(corner, p))
            x = np.asarray(image[sl], np.float32)
            if scale is not None:
                x = x * scale
            slc = tuple(
                slice(a + c, a + c + b) for a, b in zip(corner, out)
            )
            y = labels[slc]
            m = mask[slc]
            if augment:
                code = int(rng.integers(16))
                x, y, m = (_apply_code(v, code) for v in (x, y, m))
            xs.append(x)
            ys.append(y)
            ms.append(m)
        yield np.stack(xs), np.stack(ys), np.stack(ms)
