#!/usr/bin/env python
"""Multi-host scale-out demo: the sharded FIR+periodogram chain running
SPMD across N OS processes (one per "host") joined with
`libtsd_jax.parallel.launch.initialize` over gloo.

Topology: mesh ("chan", "time") with chan = #processes (each host owns a
contiguous block of channels — data-parallel over hosts, nothing crosses
hosts in steady state) and time = #local devices per host (sequence
parallelism with halo exchange + psum inside each host).  Each host
ingests ONLY its own channels (ingest_local — the host ingest boundary),
then every process executes the same global SPMD program.

This is an explicit CPU simulation: the "hosts" are localhost processes,
each with virtual CPU devices, and no process touches a GPU.  On a real
multi-host GPU cluster the worker body is unchanged apart from dropping
the CPU forcing (one process per host, its local GPUs on "time").

    python examples/multihost_demo.py            # launcher: spawn 2 hosts
    python examples/multihost_demo.py --nproc 4
"""
import argparse
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LOCAL_DEVICES = 2        # virtual devices per "host"
NFFT_CHUNK = 65536       # samples per time shard
TAPS = 128


def gen_channel(c: int, n: int):
    import numpy as np
    return np.random.default_rng(1000 + c).standard_normal(n).astype(np.float32)


def worker(coordinator: str, nproc: int, pid: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count={LOCAL_DEVICES}").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")

    # initialize() must run before anything touches the XLA backend —
    # including library imports that build constant tables on device
    from libtsd_jax.parallel import launch
    launch.initialize(coordinator_address=coordinator,
                      num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc

    import jax.numpy as jnp
    import numpy as np

    from libtsd_jax.ops import fir_design as FD
    from libtsd_jax.parallel import make_mesh, P, sharded_fir_periodogram4096

    # global mesh: hosts on "chan", local devices on "time"
    mesh = make_mesh(chan=nproc, time=LOCAL_DEVICES)
    C = 2 * nproc
    N = LOCAL_DEVICES * NFFT_CHUNK

    h = jnp.asarray(FD.fir_lowpass(TAPS, 0.2), jnp.float32)

    # host ingest boundary: this host materializes ONLY its channels
    per = C // nproc
    local = np.stack([gen_channel(c, N)
                      for c in range(pid * per, (pid + 1) * per)])
    x = launch.ingest_local(mesh, P("chan", "time"), local)

    acc = sharded_fir_periodogram4096(mesh, x, h)
    total = float(jax.jit(jnp.sum)(acc))     # cross-host reduction
    print(f"proc {pid}: CHECKSUM {total:.8e}", flush=True)


def launcher(nproc: int) -> None:
    import numpy as np

    with socket.socket() as s:               # pick a free port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         "--coordinator", coord, "--nproc", str(nproc), "--pid", str(p)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": REPO + ":" +
             os.environ.get("PYTHONPATH", "")})
        for p in range(nproc)]
    checks = []
    for p, pr in enumerate(procs):
        out, _ = pr.communicate(timeout=600)
        assert pr.returncode == 0, f"worker {p} failed:\n{out}"
        for line in out.splitlines():
            if "CHECKSUM" in line:
                print(line)
                checks.append(float(line.split()[-1]))

    # single-device oracle in this process
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from libtsd_jax.ops import fir_design as FD
    from libtsd_jax.ops.chain import fir_periodogram4096

    C = 2 * nproc
    N = LOCAL_DEVICES * NFFT_CHUNK
    x = jnp.asarray(np.stack([gen_channel(c, N) for c in range(C)]))
    h = jnp.asarray(FD.fir_lowpass(TAPS, 0.2), jnp.float32)
    ref = float(jnp.sum(fir_periodogram4096(x, h)))

    assert len(checks) == nproc
    for v in checks:
        rel = abs(v - ref) / abs(ref)
        assert rel < 1e-5, (v, ref, rel)
    print(f"MULTIHOST OK: {nproc} hosts x {LOCAL_DEVICES} devices, "
          f"checksum matches single-device oracle ({ref:.8e})")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--pid", type=int, default=0)
    a = ap.parse_args()
    if a.worker:
        worker(a.coordinator, a.nproc, a.pid)
    else:
        launcher(a.nproc)


if __name__ == "__main__":
    main()
