"""Multi-host bring-up actually executed: two REAL processes join via
jax.distributed on CPU, see the global device set, run a collective, and
take one data-parallel train step (SURVEY.md section 2.3 comm row — this
was claim-only until round 2).
"""

import json
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent(
    """
    import json, os, sys

    # the script runs from a tmp dir: put the repo on sys.path explicitly
    sys.path.insert(0, os.environ["FLYPYLIB_REPO"])

    import jax

    # force the CPU platform before any backend initialization
    jax.config.update("jax_platforms", "cpu")

    from flypylib_tpu.parallel.distributed import (
        ensure_initialized,
        local_batch_size,
    )

    coord = sys.argv[1]
    pid = int(sys.argv[2])
    active = ensure_initialized(
        coordinator_address=coord, num_processes=2, process_id=pid
    )

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    devs = jax.devices()
    mesh = Mesh(np.asarray(devs), ("data",))

    # global psum over both processes' devices
    local = np.full((2, 4), float(jax.process_index() + 1), np.float32)
    garr = jax.make_array_from_process_local_data(
        jax.NamedSharding(mesh, P("data")), local
    )
    total = shard_map(
        lambda x: jax.lax.psum(jnp.sum(x), "data"),
        mesh=mesh, in_specs=P("data"), out_specs=P(),
        check_vma=False,
    )(garr)
    psum_val = float(np.asarray(jax.device_get(total)))

    # one dp train step over the global mesh (replicated host data)
    from flypylib_tpu.models.zoo import baseline_model
    from flypylib_tpu.parallel import make_dp_train_step
    from flypylib_tpu.train.trainer import TrainConfig, TrainData, Trainer

    spec = baseline_model(features=(4,), dilations=(1,), head_features=8,
                          dtype=jnp.float32)
    cfg = TrainConfig(patch_size=9, batch_size=len(devs), steps_per_epoch=1)
    rng = np.random.default_rng(0)  # same data on every process
    image = rng.random((16, 16, 16)).astype(np.float32)
    labels = (rng.random((16, 16, 16)) > 0.9).astype(np.float32)
    mask = np.ones((16, 16, 16), np.float32)
    data = TrainData.build(image, labels, mask, spec.valid_size(9))
    trainer = Trainer(spec, cfg, seed=0)
    state = trainer.init_state()
    step, _, _ = make_dp_train_step(spec, cfg, mesh)
    state, metrics = step(state, jax.random.PRNGKey(0), data)
    loss = float(jax.device_get(metrics["loss"]))

    # --- volume-sharded inference + NMS + CC across BOTH processes ---
    # (multi-process staging goes through make_array_from_callback /
    # process_allgather, never host-local arrays into a global-mesh jit)
    from flypylib_tpu.ops.host_reference import components_host, nms_host
    from flypylib_tpu.parallel.halo import (
        _host_gather,
        sharded_components,
        sharded_infer,
        sharded_nms,
    )

    ispec = baseline_model(features=(4,), dilations=(1,), head_features=8,
                           dtype=jnp.float32)
    ivars = jax.device_get(
        ispec.init(jax.random.PRNGKey(1), ispec.valid_size(9))
    )
    rng2 = np.random.default_rng(42)  # identical volume on every process
    vol = rng2.random((32, 16, 16)).astype(np.float32)
    smesh = Mesh(np.asarray(jax.devices()), ("space",))
    gprob = sharded_infer(ispec, ivars, vol, smesh)
    prob_sh = np.asarray(_host_gather(gprob))

    # monolithic reference on the local host
    cpad = ispec.context
    xm = np.pad(vol, cpad, mode="reflect")
    prob_mono = np.asarray(jax.jit(
        lambda v, x: jax.nn.sigmoid(
            ispec.module.apply(v, x[None, ..., None], train=False)[0, ..., 0]
        )
    )(ivars, xm))
    thr = float(np.quantile(prob_mono, 0.98))
    det = sharded_nms(gprob, smesh, window=3, threshold=thr,
                      max_per_shard=64)
    det_mono = nms_host(prob_mono, window=3, threshold=thr)
    cc = sharded_components(gprob, smesh, threshold=thr,
                            max_components=64)
    cc_mono = components_host(prob_mono, threshold=thr)

    def same(a, b):
        return (len(a) == len(b)
                and bool(np.array_equal(np.asarray(a.locs),
                                        np.asarray(b.locs)))
                and bool(np.allclose(a.conf, b.conf, rtol=1e-6)))

    # 2-D (z x y) mesh across the two processes: staging slices both
    # sharded dims per process; NMS halos exchange over both axes
    mesh2 = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("z", "y"))
    gprob2 = sharded_infer(ispec, ivars, vol, mesh2, axis=("z", "y"))
    prob2 = np.asarray(_host_gather(gprob2))
    det2 = sharded_nms(gprob2, mesh2, axis=("z", "y"), window=3,
                       threshold=thr, max_per_shard=64)

    print(json.dumps({
        "active": bool(active),
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "global_devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
        "psum": psum_val,
        "local_batch": local_batch_size(len(devs)),
        "loss": loss,
        "sharded_prob_equal": bool(np.array_equal(prob_sh, prob_mono)),
        "sharded_nms_equal": same(det, det_mono),
        "sharded_cc_equal": same(cc, cc_mono),
        "sharded2d_prob_equal": bool(np.array_equal(prob2, prob_mono)),
        "sharded2d_nms_equal": same(det2, det_mono),
        "n_det": len(det),
    }))
    """
)


def test_two_process_distributed_cpu(tmp_path):
    port = _free_port()
    coord = f"localhost:{port}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    import os

    from pathlib import Path

    import flypylib_tpu

    env = dict(
        os.environ,
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        FLYPYLIB_REPO=str(Path(flypylib_tpu.__file__).parents[1]),
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env,
        )
        for i in range(2)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        results.append(json.loads(out.strip().splitlines()[-1]))

    for i, r in enumerate(sorted(results, key=lambda r: r["process_index"])):
        assert r["active"] is True
        assert r["process_index"] == i
        assert r["process_count"] == 2
        assert r["global_devices"] == 4  # 2 virtual CPU devices per process
        assert r["local_devices"] == 2
        # psum of per-process constants: 8*(1) + 8*(2) = 24
        assert r["psum"] == 24.0
        assert r["local_batch"] == 2
        assert r["loss"] == results[0]["loss"]  # identical on both hosts
        assert r["loss"] > 0
        # sharded detection across 2 processes == monolithic, exactly
        assert r["sharded_prob_equal"] is True
        assert r["sharded_nms_equal"] is True
        assert r["sharded_cc_equal"] is True
        assert r["sharded2d_prob_equal"] is True
        assert r["sharded2d_nms_equal"] is True
        assert r["n_det"] > 0 and r["n_det"] == results[0]["n_det"]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port
