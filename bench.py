"""Benchmark: end-to-end predict + NMS + CC throughput (Mvox/s/device).

Sections (each prints the merged-so-far JSON line when it ends):

- ``staged_1k``: 1024^3 whole-volume predict + NMS + CC through
  ``infer/large.detect_staged`` (one uint8 device staging upload + a
  device-sliced ROI sweep, method="both"; eval config 2,
  BASELINE.json:8), reported end to end (``streaming_1k_mvox_s``) and
  device-resident (``device_resident_1k_mvox_s``, the headline
  ``value``);
- ``unet_1k``: the same for the packed U-Net;
- ``host``: the CPU reference (jax-CPU conv forward + scipy NMS/CC on the
  host, BASELINE.json:7 eval config 1) on a small cutout, plus model
  FLOPs per voxel from XLA's cost analysis; ``vs_baseline`` divides the
  headline by it;
- ``wire_256``: 256^3 end to end from host memory and device-resident;
- ``train``: steady-state train throughput at three operating points;
- ``unet``: U-Net device-resident predict + NMS + CC at 384^3 in one
  covering tile.

Sections run in priority order; a wall-clock budget (``--budget`` seconds
or env ``BENCH_BUDGET_S``, default 2700) skips sections not yet started.
Times are the minimum over a few runs after a warm-up.  The script exits
non-zero when no GPU is present or when any section errored.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def make_volume(size: int, n_blobs: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.1, 0.05, (size,) * 3).astype(np.float32)
    centers = rng.integers(5, size - 5, (n_blobs, 3))
    g = np.arange(-4, 5)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    blob = np.exp(-(zz**2 + yy**2 + xx**2) / (2 * 2.0**2)).astype(np.float32)
    for c in centers:
        sl = tuple(slice(c[i] - 4, c[i] + 5) for i in range(3))
        vol[sl] = np.maximum(vol[sl], blob)
    return np.clip(vol, 0, 1)


def make_volume_u8(size: int, n_blobs: int, seed: int = 0) -> np.ndarray:
    """Chunked uint8 builder (1k^3 needs ~1 GB, not 8 GB of f64 noise)."""
    rng = np.random.default_rng(seed)
    vol = np.empty((size,) * 3, np.uint8)
    step = max(1, (1 << 27) // (size * size))  # ~128 MB f32 slabs
    for z0 in range(0, size, step):
        z1 = min(size, z0 + step)
        sl = rng.normal(0.1, 0.05, (z1 - z0, size, size)).astype(np.float32)
        vol[z0:z1] = (np.clip(sl, 0, 1) * 255).astype(np.uint8)
    centers = rng.integers(5, size - 5, (n_blobs, 3))
    g = np.arange(-4, 5)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    blob = (
        np.exp(-(zz**2 + yy**2 + xx**2) / (2 * 2.0**2)) * 255
    ).astype(np.uint8)
    for c in centers:
        sl = tuple(slice(c[i] - 4, c[i] + 5) for i in range(3))
        vol[sl] = np.maximum(vol[sl], blob)
    return vol


def _flagship(dtype=None):
    import jax

    from flypylib_tpu.models.zoo import baseline_model
    from flypylib_tpu.ops.packed_conv import packed_spec

    spec = baseline_model()
    pspec = packed_spec(spec)
    tin = pspec.valid_size(128 + 2 * pspec.context)
    variables = spec.init(jax.random.PRNGKey(0), tin)
    return pspec, variables


def bench_256(size: int = 256, tile_out: int = 64, tile_batch: int = 16):
    # tile 64 x batch 16: the default_tiling choice for conv stacks
    # (not yet swept on the GPU)
    import jax.numpy as jnp  # noqa: F401  (backend init)

    from flypylib_tpu.infer.pipeline import DetectPipeline

    pspec, variables = _flagship()
    # uint8 grayscale on the wire (EM volumes are uint8 natively; 4x less
    # host->HBM traffic than f32)
    vol = (make_volume(size, n_blobs=max(8, size // 16)) * 255).astype(
        np.uint8
    )

    # operating threshold = in-graph quantile of the probability map tuned
    # for ~2000 candidate voxels regardless of volume size, so NMS/CC
    # process realistic (non-saturating) counts on an untrained net
    q = 1.0 - 2000.0 / vol.size
    pipe = DetectPipeline(
        pspec, variables, vol.shape, tile_out=tile_out,
        tile_batch=tile_batch, window=5, threshold_quantile=q,
        max_detections=4096, max_components=4096,
    )
    nms_det, cc_det = pipe(vol)  # warm-up / compile
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        pipe(vol)
        times.append(time.perf_counter() - t0)
    wire_dt = min(times)

    # device-resident: volume staged on device once; fused single-dispatch
    # forward + NMS + CC only
    staged = pipe.stage_full(vol)
    pipe.postprocess(pipe.forward_full(staged))  # warm
    dev_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        pipe.postprocess(pipe.forward_full(staged))
        dev_times.append(time.perf_counter() - t0)
    dev_dt = min(dev_times)

    return {
        "value": vol.size / wire_dt / 1e6,
        "device_resident_mvox_s": vol.size / dev_dt / 1e6,
        "nms_detections": len(nms_det),
        "cc_components": len(cc_det),
        "seconds": wire_dt,
        "device_resident_seconds": dev_dt,
    }


def bench_staged_1k(size: int = 1024, core: int = 512):
    """Eval config 2 [B:8] / north star [B:5]: 1k^3 whole-volume
    predict + NMS + CC (method="both", sparse CC backend).

    The volume is staged on device ONCE (uint8 — the single upload),
    then every ROI block is sliced device-to-device
    (infer/large.detect_staged).  Reports the end-to-end number (upload +
    detect) and the device-resident number (detect only — the
    per-device throughput without the upload).
    """
    import jax

    from flypylib_tpu.infer.large import (
        detect_staged,
        make_stream_plan,
        stage_volume_chunked,
    )
    from flypylib_tpu.infer.tiled import infer_volume

    pspec, variables = _flagship()
    vol = make_volume_u8(size, n_blobs=max(64, size // 8))

    # pick the operating threshold from a small probe cutout (untrained
    # net: a quantile keeps candidate counts realistic)
    probe = infer_volume(
        pspec, variables,
        vol[:128, :128, :128].astype(np.float32) / 255.0, tile_out=128,
    )
    thr = float(np.quantile(probe, 0.9999))

    # core=512: ROI halo redundancy (528/512)^3 = 1.10 vs 1.20 at core
    # 256, and 8 ROIs instead of 64 cut the per-ROI postprocess
    # roundtrips 8x.
    # k=32768 clears the ~15k candidates/ROI the 0.9999-quantile
    # operating point yields at this core size — a saturated k would
    # silently time the grow-and-retry second pass.
    common = dict(window=5, threshold=thr,
                  max_detections_per_roi=32768,
                  max_components_per_roi=32768, method="both")
    plan = make_stream_plan(pspec, variables, vol.shape, core=core,
                            **common)

    # chunked staging: only the raw bytes cross the wire (halo windows
    # are assembled on device per ROI), and an ROI's forward can start
    # once ITS chunks have arrived
    t0 = time.perf_counter()
    staged = stage_volume_chunked(vol, plan=plan)
    jax.block_until_ready(staged.chunks)
    t_up = time.perf_counter() - t0
    # forward="auto" resolves to the shared whole-volume forward when its
    # peak device-memory estimate fits; record which mode actually ran
    fwd_mode = (
        "shared"
        if plan.shared_auto(sum(c.nbytes for c in staged.chunks))
        else "roi"
    )

    # compile warm-up: one ROI through the shared plan, then every ROI
    # window-assembly signature (tiny pad/concat executables)
    grid = plan.grid
    plan.grid = grid[:1]
    detect_staged(pspec, variables, vol, staged=staged, plan=plan,
                  **common)
    plan.grid = grid
    for _, corner in grid:
        staged.window(tuple(corner), plan.pipe.padded_shape)

    # device-resident: min-of-3 over the resident chunks (window
    # assembly is ~ms of device copies)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        nms_det, cc_det = detect_staged(pspec, variables, vol,
                                        staged=staged, plan=plan, **common)
        times.append(time.perf_counter() - t0)
    dt = min(times)

    # overlapped end-to-end: a FRESH chunk upload with the sweep
    # dispatched behind it — an ROI's window assembly waits only on ITS
    # chunks, so early ROI z-rows compute while later chunks transfer.
    # Reported as its own metric beside the t_up + dt composition.
    t0 = time.perf_counter()
    staged2 = stage_volume_chunked(vol, plan=plan)
    nms_det2, cc_det2 = detect_staged(pspec, variables, vol,
                                      staged=staged2, plan=plan, **common)
    t_e2e = time.perf_counter() - t0
    assert len(nms_det2) == len(nms_det)
    return {
        "streaming_1k_mvox_s": vol.size / (t_up + dt) / 1e6,
        "device_resident_1k_mvox_s": vol.size / dt / 1e6,
        "staged_1k_upload_seconds": t_up,
        "streaming_1k_overlap_mvox_s": vol.size / t_e2e / 1e6,
        "streaming_1k_overlap_seconds": t_e2e,
        "device_resident_1k_seconds": dt,
        "device_resident_1k_seconds_all": [round(t, 3) for t in times],
        "streaming_1k_forward_mode": fwd_mode,
        "streaming_1k_detections": len(nms_det),
        "streaming_1k_components": len(cc_det),
    }


def bench_train(steps: int = 100, batch: int = 32, patch: int = 33):
    """Eval config 3 [B:9]: steady-state train throughput of the
    single-dispatch scanned step (on-device sampling + fused flip/rot
    augment + fwd/bwd + Adam)."""
    import jax

    from flypylib_tpu.models.zoo import baseline_model
    from flypylib_tpu.train.trainer import (
        TrainConfig,
        TrainData,
        Trainer,
        make_train_step,
    )

    spec = baseline_model()
    rng = np.random.default_rng(0)
    size = 128
    image = rng.integers(0, 256, (size,) * 3).astype(np.uint8)
    labels = (rng.random((size,) * 3) > 0.999).astype(np.float32)
    mask = np.ones((size,) * 3, np.float32)
    out = {}
    # three operating points: plain and packed at batch 32, plain at
    # batch 128
    for engine, prefix, bsz, n in (
        ("plain", "train", batch, steps),
        ("packed", "train_packed", batch, steps),
        ("plain", "train_b128", 128, max(25, steps // 2)),
    ):
        cfg = TrainConfig(patch_size=patch, batch_size=bsz, augment=True,
                          steps_per_epoch=n, engine=engine)
        _, epoch_step, pvox = make_train_step(spec, cfg)
        data = TrainData.build(image, labels, mask, pvox)
        tr = Trainer(spec, cfg, seed=0)
        state = tr.init_state()
        keys = jax.random.split(jax.random.PRNGKey(1), n)
        state, m = epoch_step(state, keys, data)  # compile + warm
        float(m["loss"])
        t0 = time.perf_counter()
        state, m = epoch_step(state, keys, data)
        float(m["loss"])
        dt = time.perf_counter() - t0
        out[f"{prefix}_steps_per_s"] = n / dt
        out[f"{prefix}_patch_mvox_s"] = n * bsz * pvox**3 / dt / 1e6
    return out


def bench_unet(size: int = 384):
    """Eval config 4 [B:10]: U-Net device-resident predict + NMS + CC
    throughput through the packed U-Net engine."""
    from flypylib_tpu.infer.pipeline import DetectPipeline
    from flypylib_tpu.models.zoo import unet
    from flypylib_tpu.ops.packed_unet import packed_unet_spec

    import jax

    spec = unet()
    pspec = packed_unet_spec(spec) or spec
    tin = pspec.valid_size(64 + 2 * pspec.context)
    variables = spec.init(jax.random.PRNGKey(0), tin)
    vol = (make_volume(size, n_blobs=max(8, size // 16)) * 255).astype(
        np.uint8
    )
    q = 1.0 - 2000.0 / vol.size
    # ONE monolithic covering tile (tin 428) over the whole volume
    pipe = DetectPipeline(
        pspec, variables, vol.shape, tile_out=size, tile_batch=1,
        window=5, threshold_quantile=q,
        max_detections=4096, max_components=4096,
    )
    staged = pipe.stage_full(vol)
    pipe.postprocess(pipe.forward_full(staged))  # warm
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        pipe.postprocess(pipe.forward_full(staged))
        times.append(time.perf_counter() - t0)
    return {"unet_device_resident_mvox_s": vol.size / min(times) / 1e6}


def bench_unet_1k(size: int = 1024):
    """Eval config 4 at the north-star scale [B:10][B:5]: packed U-Net
    whole-volume predict + NMS + CC at 1k^3 via detect_staged with
    all-default geometry (cost-aware core, ONE phase-aligned covering
    tile per ROI, fused method="both" postprocess)."""
    import jax

    from flypylib_tpu.infer.large import (
        detect_staged,
        make_stream_plan,
        stage_volume_chunked,
    )
    from flypylib_tpu.infer.tiled import infer_volume
    from flypylib_tpu.models.zoo import unet
    from flypylib_tpu.ops.packed_unet import packed_unet_spec

    spec = unet()
    pspec = packed_unet_spec(spec) or spec
    variables = spec.init(
        jax.random.PRNGKey(0), pspec.valid_size(64 + 2 * pspec.context)
    )
    vol = make_volume_u8(size, n_blobs=max(64, size // 8))
    probe = infer_volume(
        pspec, variables,
        vol[:128, :128, :128].astype(np.float32) / 255.0, tile_out=128,
    )
    thr = float(np.quantile(probe, 0.9999))
    common = dict(window=5, threshold=thr, max_detections_per_roi=32768,
                  max_components_per_roi=32768, method="both")
    plan = make_stream_plan(pspec, variables, vol.shape, **common)

    t0 = time.perf_counter()
    staged = stage_volume_chunked(vol, plan=plan)
    jax.block_until_ready(staged.chunks)
    t_up = time.perf_counter() - t0

    grid = plan.grid
    plan.grid = grid[:1]
    detect_staged(pspec, variables, vol, staged=staged, plan=plan, **common)
    plan.grid = grid
    for _, corner in grid:
        staged.window(tuple(corner), plan.pipe.padded_shape)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        nms_det, cc_det = detect_staged(pspec, variables, vol,
                                        staged=staged, plan=plan, **common)
        times.append(time.perf_counter() - t0)
    dt = min(times)
    fwd_mode = (
        "shared"
        if plan.shared_auto(sum(c.nbytes for c in staged.chunks))
        else "roi"
    )
    return {
        "unet_1k_device_resident_mvox_s": vol.size / dt / 1e6,
        "unet_1k_mvox_s": vol.size / (t_up + dt) / 1e6,
        "unet_1k_forward_mode": fwd_mode,
        "unet_1k_detections": len(nms_det),
        "unet_1k_components": len(cc_det),
    }


_HOST_SNIPPET = """
import json, time
import numpy as np
import jax
import jax.numpy as jnp
from bench import make_volume
from flypylib_tpu.models.zoo import baseline_model, unet
from flypylib_tpu.ops.host_reference import components_host, nms_host

assert jax.devices()[0].platform == "cpu", jax.devices()
out = {{}}

# --- model FLOPs (XLA HLO cost analysis on CPU — backend-independent
# flop count) per output voxel, compile-only, at a large-ish valid tile
# so valid-conv edge overhead is small ---
for name, spec_fn, s in (("baseline", baseline_model, 128),
                         ("unet", unet, 128)):
    spec = spec_fn(dtype=jnp.float32)
    tin = spec.valid_size(s + 2 * spec.context)
    v = spec.init(jax.random.PRNGKey(0), tin)
    x = jnp.zeros((1, tin, tin, tin, 1), jnp.float32)
    comp = jax.jit(
        lambda v, x, m=spec.module: m.apply(v, x, train=False)
    ).lower(v, x).compile()
    ca = comp.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    tout = tin - 2 * spec.context
    out[name + "_flops_per_voxel"] = float(ca["flops"]) / tout**3

# --- flypylib-equivalent CPU reference (eval config 1, BASELINE.json:7):
# conv forward on CPU + scipy NMS/CC on host ---
size = {size}
spec = baseline_model(dtype=jnp.float32)
c = spec.context
variables = spec.init(jax.random.PRNGKey(0), 2 * c + 9)
vol = make_volume(size, n_blobs=max(8, size // 16))
padded = np.pad(vol, c, mode="reflect")
x = jnp.asarray(padded[None, ..., None])
fwd = jax.jit(lambda v, x: jax.nn.sigmoid(
    spec.module.apply(v, x, train=False)[0, ..., 0]))
prob = np.asarray(fwd(variables, x))  # compile
thr = float(np.quantile(prob, 0.999))
t0 = time.perf_counter()
prob = np.asarray(fwd(variables, x))
nms_host(prob, window=5, threshold=thr)
components_host(prob, threshold=thr)
dt = time.perf_counter() - t0
out["mvox_s"] = vol.size / dt / 1e6
print(json.dumps(out))
"""


def bench_host(size: int = 64):
    """CPU reference + analytic model FLOPs, in one subprocess.

    The subprocess starts with ``JAX_PLATFORMS=cpu`` and no visible
    GPU, so it never opens the card (one JAX process per card)."""
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-c", _HOST_SNIPPET.format(size=size)],
        capture_output=True, text=True, timeout=1200, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    if out.returncode:
        raise RuntimeError(f"host reference failed: {out.stderr[-500:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    return {
        "cpu_reference_mvox_s": res["mvox_s"],
        "cpu_reference_size": size,
        "baseline_flops_per_voxel": round(res["baseline_flops_per_voxel"]),
        "unet_flops_per_voxel": round(res["unet_flops_per_voxel"]),
    }


def _assemble(acc: dict, progress: list, t_start: float) -> str:
    """Merge accumulated section results into the driver JSON line."""
    north = acc.get("device_resident_1k_mvox_s")
    wire256 = acc.get("wire_256_mvox_s")
    value = north if north is not None else wire256
    cpu = acc.get("cpu_reference_mvox_s")
    vs = (value / cpu) if (value and cpu) else None

    # achieved model TFLOP/s (XLA cost-analysis FLOPs x voxel rate)
    derived = {}
    fpv = acc.get("baseline_flops_per_voxel")
    if fpv and north:
        derived["north_star_tflops"] = round(fpv * north * 1e6 / 1e12, 1)
    ufpv = acc.get("unet_flops_per_voxel")
    unet1k = acc.get("unet_1k_device_resident_mvox_s")
    if ufpv and unet1k:
        derived["unet_1k_tflops"] = round(ufpv * unet1k * 1e6 / 1e12, 1)

    import jax

    dev = jax.devices()[0]
    line = {
        "metric": (
            "1k^3 predict+nms+cc device-resident Mvox/s/device "
            "(wire_256_mvox_s = 256^3 end to end from host memory)"
        ),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "value": round(value, 2) if value is not None else None,
        "unit": "Mvox/s",
        "vs_baseline": round(vs, 2) if vs else None,
        **derived,
        **{
            # sub-unit floats (e.g. the 0.012 Mvox/s CPU reference) keep
            # enough digits to stay meaningful
            k: (round(v, 2 if abs(v) >= 1 else 5)
                if isinstance(v, float) else v)
            for k, v in acc.items()
        },
        "bench_sections": ",".join(progress),
        "bench_elapsed_s": round(time.monotonic() - t_start, 1),
    }
    return json.dumps(line)


def main():
    import jax

    from flypylib_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if jax.devices()[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {jax.devices()}",
              file=sys.stderr)
        sys.exit(2)

    args = sys.argv[1:]
    budget = float(os.environ.get("BENCH_BUDGET_S", 2700))
    size = 256
    only = None
    while args:
        a = args.pop(0)
        if a == "--budget":
            budget = float(args.pop(0))
        elif a == "--only":
            only = set(args.pop(0).split(","))
        else:
            size = int(a)

    def _wire_256():
        info = bench_256(size=size)
        info["wire_256_mvox_s"] = info.pop("value")
        return info

    sections = [
        ("staged_1k", bench_staged_1k),
        ("unet_1k", bench_unet_1k),
        ("host", bench_host),
        ("wire_256", _wire_256),
        ("train", bench_train),
        ("unet", bench_unet),
    ]

    t_start = time.monotonic()
    acc: dict = {}
    progress: list = []
    failed = False
    for name, fn in sections:
        if only is not None and name not in only:
            continue
        if time.monotonic() - t_start > budget:
            progress.append(f"{name}:skipped")
        else:
            try:
                acc.update(fn())
                progress.append(name)
            except Exception as e:
                acc[f"{name}_error"] = str(e)[:200]
                progress.append(f"{name}:error")
                failed = True
        print(_assemble(acc, progress, t_start), flush=True)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
