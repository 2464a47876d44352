"""Multi-process (multi-"host") scale-out test: N real OS processes join
via jax.distributed.initialize over gloo and run the sharded
FIR+periodogram chain SPMD (parallel/launch.py + parallel/chain.py).

This is the cross-host half of SURVEY §5.8, validated as an explicit CPU
simulation — real separate processes, real collectives, checksum
pinned to the single-device oracle (examples/multihost_demo.py launcher
asserts it and prints MULTIHOST OK).
"""
import os
import subprocess
import sys
import pytest

# tier-2: long statistical sweep — excluded from the <3-min default loop
pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_spmd():
    env = {**os.environ, "PYTHONPATH": REPO + ":" +
           os.environ.get("PYTHONPATH", "")}
    # drop this pytest process's 8-device forcing; workers set their own
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "multihost_demo.py"),
         "--nproc", "2"],
        capture_output=True, text=True, timeout=540, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "MULTIHOST OK" in out.stdout, out.stdout
