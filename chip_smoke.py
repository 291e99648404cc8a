#!/usr/bin/env python3
"""Smoke run of the main path on one GPU: train -> detect at zoo width.

    python chip_smoke.py          # one card: train, detect_256, detect_1k, unet
    python chip_smoke.py --four   # four cards: the multi-device paths only

Every phase goes through the public entry points (``FplNetwork.train``,
``infer``, ``detect``, ``detect_large``; ``detect_staged``,
``sharded_infer`` and ``sharded_nms`` under ``--four``), with seeded
synthetic volumes and seeded random weights, and checks its output
against a reference:

- detection lists against the scipy host reference
  (``ops.host_reference.nms_host``) run on the same probability map —
  exact, since NMS only compares values;
- probability maps against the plain float32 model under
  ``jax.default_matmul_precision("highest")`` — within a stated
  tolerance, because the model runs its convolutions in bfloat16;
- detection lists of two modes (shared vs per-ROI forward, one device vs
  four) — reported as bitwise when they are, else held to a stated
  match tolerance, because the two modes run different executables
  whose convolution algorithms the GPU autotuner picks per shape.

A failed check raises, so the script exits non-zero.  It refuses to run
without a GPU or outside a checkout of the repository.  The last line of
standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# synthetic-volume edges of each phase
SIZES = {"train": 128, "d256": 256, "d1k": 1024, "unet": 384}

# Tolerances, each with its reason:
# - first-step loss, packed vs plain engine: both run bf16 convolutions;
#   the packed engine re-associates the same products (space-to-depth),
#   so bf16 rounding of the activations differs (~2^-8 relative).
LOSS_TOL = 2e-2
# - probability map, bf16 packed engine vs the f32 plain model at
#   "highest" precision: bf16 keeps 8 mantissa bits, the error compounds
#   over the 6 (conv stack) or 11 (U-Net) convolutions, and sigmoid
#   scales logit errors by at most 1/4.
PROB_MAX_TOL = {"baseline": 3e-2, "unet": 5e-2}
PROB_MEAN_TOL = {"baseline": 3e-3, "unet": 5e-3}
# - detection lists of two modes that are not bitwise equal: share of
#   detections found at the same voxel in both, and the largest
#   confidence difference among those (bf16 last-bit differences move
#   near-tied local maxima and threshold crossings).
MATCH_FRAC_TOL = 0.98
CONF_TOL = 1e-2
# - data-parallel training vs one card, after one epoch: per-epoch loss,
#   and params (Adam turns tiny gradient differences into lr-sized steps)
DP_LOSS_TOL = 2e-2
DP_PARAM_TOL = 3e-2

log = print


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def preflight(n_devices: int):
    """GPU present, enough cards, repo importable; prints the setup."""
    if not os.path.isdir(os.path.join(HERE, "flypylib_tpu")):
        print("chip_smoke: run it from a checkout of the repository "
              "(flypylib_tpu/ not found beside it)", file=sys.stderr)
        sys.exit(2)
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devs}", file=sys.stderr)
        sys.exit(2)
    if len(devs) < n_devices:
        print(f"chip_smoke: needs {n_devices} GPUs, found {len(devs)}",
              file=sys.stderr)
        sys.exit(2)
    from flypylib_tpu.utils.cache import enable_compilation_cache

    cache = enable_compilation_cache()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()
    for line in cards:
        log(f"card: {line}")
    # one line per GPU; the phase lines name the first card (and how
    # many there are when every card reads the same)
    smi = cards[0] if cards else "nvidia-smi: no output"
    if len(cards) > 1:
        smi = (f"{len(cards)} x {smi}" if len(set(cards)) == 1
               else "; ".join(cards))
    log(f"jax {jax.__version__}; devices {len(devs)} x "
        f"{devs[0].device_kind}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache}")
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("  [%(name)s] %(message)s"))
    lg = logging.getLogger("flypylib_tpu")
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    return smi


def blob_volume(size: int, n_blobs: int, seed: int):
    """Seeded uint8 EM-like volume: dim noisy background plus bright
    Gaussian blobs; returns (volume, blob centers)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vol = rng.integers(10, 50, (size,) * 3, dtype=np.uint8)
    centers = rng.integers(6, size - 6, (n_blobs, 3))
    g = np.arange(-4, 5)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    blob = (np.exp(-(zz**2 + yy**2 + xx**2) / 8.0) * 220).astype(np.uint8)
    for c in centers:
        sl = tuple(slice(c[i] - 4, c[i] + 5) for i in range(3))
        vol[sl] = np.maximum(vol[sl], blob)
    return vol, centers.astype(np.float64)


def unit(vol):
    """uint8 -> float32 in [0, 1], the scale training and the staged
    detection paths apply to uint8 input in-graph (``infer``/``detect``
    and ``sharded_infer`` feed uint8 at its raw 0..255 values, so they
    get the scaled float volume here)."""
    import numpy as np

    return vol.astype(np.float32) * np.float32(1.0 / 255.0)


def mem(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis: not available"
    gib = 1 << 30
    return (
        f"args {ma.argument_size_in_bytes / gib:.3f} GiB, "
        f"outputs {ma.output_size_in_bytes / gib:.3f} GiB, "
        f"temps {ma.temp_size_in_bytes / gib:.3f} GiB, "
        f"code {ma.generated_code_size_in_bytes / (1 << 20):.1f} MiB"
    )


def check_prob(name, got, ref, model: str):
    import numpy as np

    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    mx, mean = float(d.max()), float(d.mean())
    log(f"  {name}: prob vs f32 'highest' reference: max |d| {mx:.3e} "
        f"(tol {PROB_MAX_TOL[model]}), mean |d| {mean:.3e} "
        f"(tol {PROB_MEAN_TOL[model]})")
    if not (mx <= PROB_MAX_TOL[model] and mean <= PROB_MEAN_TOL[model]):
        fail(f"{name}: prob map outside tolerance")


def check_exact(name, got, ref):
    import numpy as np

    same = (len(got) == len(ref)
            and np.array_equal(got.locs, ref.locs)
            and np.array_equal(got.conf, ref.conf))
    log(f"  {name}: {len(got)} vs {len(ref)} detections, "
        f"{'identical' if same else 'DIFFERENT'} (exact required)")
    if not same:
        fail(f"{name}: detection lists differ")


def check_modes(name, a, b) -> bool:
    """Bitwise, or within the match tolerance; returns bitwise."""
    import numpy as np

    if (len(a) == len(b) and np.array_equal(a.locs, b.locs)
            and np.array_equal(a.conf, b.conf)):
        log(f"  {name}: {len(a)} detections, bitwise identical")
        return True
    ka = {tuple(p): c for p, c in zip(a.locs, a.conf)}
    kb = {tuple(p): c for p, c in zip(b.locs, b.conf)}
    common = ka.keys() & kb.keys()
    frac = len(common) / max(len(ka), len(kb), 1)
    dconf = max((abs(ka[k] - kb[k]) for k in common), default=0.0)
    log(f"  {name}: {len(a)} vs {len(b)} detections, NOT bitwise; "
        f"same-voxel share {frac:.5f} (tol >= {MATCH_FRAC_TOL}), "
        f"max conf diff {dconf:.3e} (tol {CONF_TOL})")
    if frac < MATCH_FRAC_TOL or dconf > CONF_TOL:
        fail(f"{name}: detection lists disagree beyond tolerance")
    return False


def quantile_threshold(prob, n_target: float):
    """Threshold leaving about ``n_target`` voxels above it (an untrained
    net's map is near-flat, so a quantile keeps candidate counts real)."""
    import numpy as np

    prob = np.asarray(prob)
    return float(np.quantile(prob, 1.0 - n_target / prob.size))


# ---------------------------------------------------------------------------
# one-card phases


def phase_train(size: int, batch: int = 32, steps: int = 20):
    """FplNetwork("baseline") at zoo width trains through net.train on a
    seeded volume: engine "auto" (packed below batch 96), then "plain";
    first-step losses of both engines agree."""
    import dataclasses

    import jax
    import numpy as np

    from flypylib_tpu import FplNetwork
    from flypylib_tpu.io.synapses import Tbars, make_training_volumes
    from flypylib_tpu.train.trainer import (
        TrainConfig,
        TrainData,
        make_train_step,
        resolve_engine,
        resolve_train_spec,
    )

    vol, centers = blob_volume(size, max(8, size // 4), seed=1)
    cfg = TrainConfig(patch_size=33, batch_size=batch, steps_per_epoch=steps)
    net = FplNetwork("baseline", train_config=cfg, seed=0)
    labels, mask = make_training_volumes(
        Tbars(locs=centers), vol.shape, radius=5.0, border=net.context
    )
    spec = net.spec
    engine = resolve_engine(spec, cfg)
    patch = resolve_train_spec(spec, cfg).valid_size(cfg.patch_size)
    # the plain engine samples the same patch size, so both see the same
    # batch from the same key
    cfg_plain = dataclasses.replace(cfg, engine="plain", patch_size=patch)
    log(f"  auto engine -> {engine}; patch {patch}, batch {cfg.batch_size}")

    state0 = net.trainer.init_state()
    data = TrainData.build(vol, labels, mask, patch)
    key = jax.random.PRNGKey(7)
    first = {}
    for name, c in (("auto", cfg), ("plain", cfg_plain)):
        step, epoch_step, p = make_train_step(spec, c)
        assert p == patch, (p, patch)
        _, m = step(state0, key, data)
        first[name] = float(m["loss"])
        keys = jax.random.split(key, c.steps_per_epoch)
        t0 = time.perf_counter()
        compiled = epoch_step.lower(state0, keys, data).compile()
        log(f"  {name} epoch step: {mem(compiled)}; compiled in "
            f"{time.perf_counter() - t0:.1f} s")
    d = abs(first["auto"] - first["plain"])
    log(f"  first-step loss: auto({engine}) {first['auto']:.6f}, plain "
        f"{first['plain']:.6f}, |d| {d:.2e} (tol {LOSS_TOL})")
    if not (np.isfinite(list(first.values())).all() and d <= LOSS_TOL):
        fail("train: first-step losses disagree or are not finite")

    hist = net.train(vol, labels, mask, epochs=1)
    net_plain = FplNetwork("baseline", train_config=cfg_plain, seed=0)
    hist_plain = net_plain.train(vol, labels, mask, epochs=1)
    for name, h in (("auto", hist), ("plain", hist_plain)):
        loss = h[-1]["loss"]
        log(f"  net.train engine={name}: {cfg.steps_per_epoch} steps, "
            f"epoch mean loss {loss:.6f}")
        if not np.isfinite(loss):
            fail(f"train: {name} loss not finite")
    return net


def phase_detect_256(net, size: int):
    """net.detect through the packed engine == nms_host on net.infer's map
    (same tiling); the packed map is close to the plain f32 model's."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flypylib_tpu import FplNetwork
    from flypylib_tpu.infer.tiled import TiledInference
    from flypylib_tpu.ops.host_reference import nms_host

    vol = unit(blob_volume(size, max(8, size // 16), seed=2)[0])
    log(f"  engine: {net.infer_spec.name}")
    prob = net.infer(vol)
    thr = quantile_threshold(prob, 2000)
    det = net.detect(vol, threshold=thr)
    check_exact("detect vs nms_host(infer)", det,
                nms_host(prob, window=5, threshold=thr))
    # tiled == monolithic is bitwise on the CPU; on the GPU each tile
    # shape is its own executable, so report what holds and hold the
    # maps to the bf16 tolerance
    other = net.infer(vol, tile_out=128, tile_batch=1)
    d = np.abs(np.asarray(other, np.float64) - np.asarray(prob, np.float64))
    log(f"  default tiling vs tile 128^3 x 1: max |d| {d.max():.3e} "
        f"({'bitwise' if d.max() == 0 else 'NOT bitwise'}; tol "
        f"{PROB_MAX_TOL['baseline']})")
    if d.max() > PROB_MAX_TOL["baseline"]:
        fail("detect_256: two tilings disagree beyond tolerance")

    ref_net = FplNetwork("baseline", dtype=jnp.float32, packed=False)
    ti = TiledInference(ref_net.spec, net.variables, tile_out=128)
    with jax.default_matmul_precision("highest"):
        ref = ti.infer(vol)
    check_prob("detect_256", prob, ref, "baseline")


def phase_detect_1k(net, size: int):
    """net.detect_large at 1k^3 with the defaults; shared and per-ROI
    forward modes agree."""
    import jax

    from flypylib_tpu.infer.large import _default_core, make_stream_plan

    vol, _ = blob_volume(size, size // 4, seed=3)
    spec, variables = net.infer_spec, net.variables
    thr = quantile_threshold(net.infer(unit(vol[:128, :128, :128])), 40)
    t0 = time.perf_counter()
    det = net.detect_large(vol, threshold=thr)
    log(f"  defaults: {len(det)} detections in "
        f"{time.perf_counter() - t0:.1f} s (compile included)")

    plan = make_stream_plan(spec, variables, vol.shape,
                            core=_default_core(spec, 5, 256, vol.shape),
                            window=5, threshold=thr)
    fp = plan.full_pipe()
    x = jax.ShapeDtypeStruct(
        (fp._tiled.tile_batch, fp._tin, fp._tin, fp._tin, 1), "float32"
    )
    fwd = jax.jit(lambda v, x: spec.module.apply(v, x, train=False))
    t0 = time.perf_counter()
    compiled = fwd.lower(variables, x).compile()
    log(f"  shared-forward tile {fp._tin}^3 x {fp._tiled.tile_batch}: "
        f"{mem(compiled)}; compiled in {time.perf_counter() - t0:.1f} s")
    out = {}
    for mode in ("shared", "roi"):
        t0 = time.perf_counter()
        out[mode] = net.detect_large(vol, threshold=thr, staged=True,
                                     forward=mode, plan=plan)
        log(f"  forward={mode}: {len(out[mode])} detections in "
            f"{time.perf_counter() - t0:.1f} s")
    bitwise = check_modes("shared vs roi", out["shared"], out["roi"])
    check_modes("defaults vs shared", det, out["shared"])
    return bitwise


def phase_unet(size: int):
    """FplNetwork("unet") at zoo width detects on a 384^3 volume through
    one covering tile; its packed map is close to the plain f32 model's."""
    import jax
    import jax.numpy as jnp

    from flypylib_tpu import FplNetwork
    from flypylib_tpu.infer.tiled import TiledInference
    from flypylib_tpu.ops.host_reference import nms_host

    net = FplNetwork("unet", seed=0)
    vol = unit(blob_volume(size, max(8, size // 16), seed=4)[0])
    log(f"  engine: {net.infer_spec.name}; context {net.context}")
    prob = net.infer(vol, tile_out=size, tile_batch=1)
    thr = quantile_threshold(prob, 2000)
    det = net.detect(vol, threshold=thr, tile_out=size, tile_batch=1)
    check_exact("unet detect vs nms_host(infer)", det,
                nms_host(prob, window=5, threshold=thr))

    ref_net = FplNetwork("unet", dtype=jnp.float32, packed=False)
    ti = TiledInference(ref_net.spec, net.variables, tile_out=128)
    with jax.default_matmul_precision("highest"):
        ref = ti.infer(vol)
    check_prob("unet", prob, ref, "unet")


# ---------------------------------------------------------------------------
# four-card phases


def phase_four_staged(net, size: int, devices):
    """detect_staged over four devices == one device, shared and roi."""
    from flypylib_tpu.infer.large import detect_staged

    vol, _ = blob_volume(size, size // 4, seed=3)
    thr = quantile_threshold(net.infer(unit(vol[:128, :128, :128])), 40)
    bitwise = {}
    for mode in ("shared", "roi"):
        res = {}
        for n in (1, 4):
            t0 = time.perf_counter()
            res[n] = detect_staged(
                net.infer_spec, net.variables, vol, threshold=thr,
                forward=mode, devices=devices[:n] if n > 1 else None,
            )
            log(f"  {mode}, {n} device(s): {len(res[n])} detections in "
                f"{time.perf_counter() - t0:.1f} s")
        bitwise[mode] = check_modes(f"staged {mode}: 4 vs 1 device",
                                    res[4], res[1])
    return bitwise


def phase_four_train(size: int, devices, batch: int = 32,
                     steps: int = 20):
    """net.train on a 4-device data mesh vs the one-card trajectory."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from flypylib_tpu import FplNetwork
    from flypylib_tpu.io.synapses import Tbars, make_training_volumes
    from flypylib_tpu.train.trainer import TrainConfig

    vol, centers = blob_volume(size, max(8, size // 4), seed=1)
    cfg = TrainConfig(patch_size=33, batch_size=batch, steps_per_epoch=steps)
    nets = {}
    for n in (1, 4):
        net = FplNetwork("baseline", train_config=cfg, seed=0)
        labels, mask = make_training_volumes(
            Tbars(locs=centers), vol.shape, radius=5.0, border=net.context
        )
        mesh = Mesh(np.asarray(devices[:n]), ("data",)) if n > 1 else None
        hist = net.train(vol, labels, mask, epochs=2, mesh=mesh)
        log(f"  {n} device(s): epoch losses "
            f"{[round(h['loss'], 6) for h in hist]}")
        nets[n] = (net, hist)
    dl = max(abs(a["loss"] - b["loss"])
             for a, b in zip(nets[1][1], nets[4][1]))
    dp = max(
        float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
        for a, b in zip(jax.tree_util.tree_leaves(nets[1][0].variables),
                        jax.tree_util.tree_leaves(nets[4][0].variables))
    )
    log(f"  dp vs single: max epoch-loss |d| {dl:.2e} (tol {DP_LOSS_TOL}),"
        f" max param |d| {dp:.2e} (tol {DP_PARAM_TOL})")
    if not (dl <= DP_LOSS_TOL and dp <= DP_PARAM_TOL):
        fail("four: data-parallel training diverged from one card")
    return nets[1][0]


def phase_four_sharded(net, size: int, devices):
    """sharded_infer + sharded_nms on a 1-D 4-device mesh vs the
    monolithic infer + nms."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from flypylib_tpu.ops.host_reference import nms_host
    from flypylib_tpu.parallel import sharded_infer, sharded_nms

    vol = unit(blob_volume(size, max(8, size // 16), seed=5)[0])
    mesh = Mesh(np.asarray(devices[:4]), ("space",))
    mono = net.infer(vol)
    thr = quantile_threshold(mono, 2000)
    t0 = time.perf_counter()
    prob = sharded_infer(net.infer_spec, net.variables, vol, mesh,
                         tile_out=64)
    det = sharded_nms(prob, mesh, window=5, threshold=thr,
                      max_per_shard=8192)
    prob = np.asarray(jax.device_get(prob))
    log(f"  sharded infer+nms: {len(det)} detections in "
        f"{time.perf_counter() - t0:.1f} s")
    d = float(np.max(np.abs(prob - mono)))
    bitwise = d == 0.0
    log(f"  sharded vs monolithic prob: max |d| {d:.3e} "
        f"({'bitwise' if bitwise else 'NOT bitwise'}; tol "
        f"{PROB_MAX_TOL['baseline']})")
    if d > PROB_MAX_TOL["baseline"]:
        fail("four: sharded prob map disagrees with monolithic")
    check_exact("sharded_nms vs nms_host(sharded prob)", det,
                nms_host(prob, window=5, threshold=thr))
    check_modes("sharded vs monolithic detections", det,
                nms_host(mono, window=5, threshold=thr))
    return bitwise


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    if set(argv) - {"--four"}:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    card = preflight(4 if four else 1)
    import jax

    t_all = time.perf_counter()

    def run(name, fn, *args):
        log(f"== phase {name}")
        t0 = time.perf_counter()
        r = fn(*args)
        log(f"   phase {name} ok in {time.perf_counter() - t0:.1f} s, "
            f"compile included ({card})")
        return r

    if four:
        devs = jax.devices()[:4]
        net = run("four_train", phase_four_train, SIZES["train"], devs)
        run("four_staged", phase_four_staged, net, SIZES["d1k"], devs)
        run("four_sharded", phase_four_sharded, net, SIZES["d256"], devs)
    else:
        net = run("train", phase_train, SIZES["train"])
        run("detect_256", phase_detect_256, net, SIZES["d256"])
        run("detect_1k", phase_detect_1k, net, SIZES["d1k"])
        run("unet", phase_unet, SIZES["unet"])
    log(f"all phases ok in {time.perf_counter() - t_all:.1f} s ({card})")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    main()
