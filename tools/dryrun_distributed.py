"""Two-process jax.distributed dryrun: the batched render as one multi-host
SPMD program (SURVEY §5.8 — DCN scale-out; here DCN = localhost grpc/gloo).

The data-parallel batch axis is the natural cross-host axis: nothing in the
render graph communicates across clips, so the only multi-host machinery is
the coordination service, the global mesh, and globally-sharded arrays
(jax.make_array_from_process_local_data).  This script proves that the path
`parallel.mesh.initialize_distributed → global ("data","block") mesh →
_batched_internal` compiles and executes across separate processes.

Usage:
  python tools/dryrun_distributed.py             # spawns the 2 workers
  python tools/dryrun_distributed.py --worker N --port P   # internal
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NUM_PROCESSES = 2
LOCAL_DEVICES = 2  # virtual CPU devices per process
BATCH = 8
RATE = 8000


def worker(process_id: int, port: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={LOCAL_DEVICES}"
    )
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    # persistent executable cache: both workers compile the same modules,
    # and the CI suite re-runs this dryrun every time — warm runs read the
    # executables from disk (cache writes are atomic, racing writers safe)
    from audio_raytracing_studio_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()

    from audio_raytracing_studio_tpu.parallel import mesh as meshlib

    meshlib.initialize_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=NUM_PROCESSES,
        process_id=process_id,
    )

    import numpy as np
    import jax.numpy as jnp

    from audio_raytracing_studio_tpu.models import pipeline
    from audio_raytracing_studio_tpu.parallel import sharding
    from audio_raytracing_studio_tpu.params import RenderParams

    n_devices = NUM_PROCESSES * LOCAL_DEVICES
    assert len(jax.devices()) == n_devices, jax.devices()
    mesh = meshlib.make_mesh(data=n_devices, block=1)
    bs = meshlib.batch_sharding(mesh)

    # Every process holds its own batch rows; the global array spans both.
    n_in = RATE // 4
    t = np.arange(n_in) / RATE
    rows_per_proc = BATCH // NUM_PROCESSES
    my_rows = range(process_id * rows_per_proc, (process_id + 1) * rows_per_proc)
    local_clips = np.stack(
        [
            np.stack([(0.3 * np.sin(2 * np.pi * (150.0 + 20 * i) * t)).astype(np.float32)] * 2)
            for i in my_rows
        ]
    )  # (B_local, 2, n)

    p = RenderParams(target_layout="5.1 (Standard)", room_size=40.0)
    setup = pipeline.build_internal_setup(p, RATE, n_in)

    def global_batch(local_np):
        return jax.make_array_from_process_local_data(bs, local_np)

    audio = global_batch(local_clips)
    seeds = global_batch(
        np.arange(BATCH, dtype=np.int32)[list(my_rows)]
    )
    ir_scalars = jax.tree.map(
        lambda x: global_batch(np.broadcast_to(np.float32(x), (rows_per_proc,))),
        setup.ir_scalars,
    )
    mix_scalars = jax.tree.map(
        lambda x: global_batch(np.broadcast_to(np.float32(x), (rows_per_proc,))),
        setup.mix_scalars,
    )

    out, metrics = sharding._batched_internal(
        audio, seeds, ir_scalars, mix_scalars,
        ir_shape=setup.ir_shape, spec=setup.spec, with_metrics=True,
    )
    jax.block_until_ready(out)
    assert out.shape == (BATCH, 6, setup.spec.len_out), out.shape
    local_out = np.concatenate([np.asarray(s.data) for s in out.addressable_shards])
    assert np.all(np.isfinite(local_out))
    assert np.max(np.abs(local_out)) > 1e-4  # rendered something real
    local_lufs = [np.asarray(s.data) for s in metrics["lufs"].addressable_shards]
    assert all(np.isfinite(v).all() for v in local_lufs)

    if process_id == 0:
        print(json.dumps({
            "ok": True,
            "processes": NUM_PROCESSES,
            "global_devices": n_devices,
            "batch": BATCH,
            "out_shape": list(out.shape),
        }))


def main() -> int:
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        pid = int(sys.argv[i + 1])
        port = int(sys.argv[sys.argv.index("--port") + 1])
        worker(pid, port)
        return 0

    import socket

    with socket.socket() as s:  # free localhost port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--worker", str(i), "--port", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO,
        )
        for i in range(NUM_PROCESSES)
    ]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    except subprocess.TimeoutExpired:
        # one worker dying pre-barrier leaves the other blocked forever in
        # the gloo/grpc coordination — kill and reap BOTH or the orphan
        # pegs this 1-core host (the documented suite-killing failure mode)
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate() for p in procs]
        for i, (o, e) in enumerate(outs):
            sys.stderr.write(
                f"--- worker {i} timed out/killed (rc={procs[i].returncode}) ---\n"
                f"{o}\n{e[-3000:]}\n"
            )
        return 1
    rcs = [p.returncode for p in procs]
    if any(rcs):
        for i, (o, e) in enumerate(outs):
            sys.stderr.write(f"--- worker {i} (rc={rcs[i]}) ---\n{o}\n{e[-3000:]}\n")
        return 1
    sys.stdout.write(outs[0][0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
