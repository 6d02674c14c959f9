"""Distribution-layer tests, isolated in a subprocess.

The actual cases live in dist_cases.py (not collected by the default
test_*.py glob).  Rationale: XLA:CPU executables that contain collectives
(shard_map / all_gather / all_to_all on the 8-virtual-device mesh) corrupt
the process heap in jax 0.9.0 — the damage detonates later, typically
inside persistent-cache deserialization (zstd) of an unrelated executable,
segfaulting the whole pytest run (reproduced: any mesh-using test followed
by warm-cache reads).  Running every mesh-using test in its own process
contains the blast radius at zero coverage cost; the child shares the
persistent compile cache, so warm runs stay fast.
"""
import os
import subprocess
import sys


def test_distributed_suite_subprocess():
    cases = os.path.join(os.path.dirname(__file__), "dist_cases.py")
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", cases, "-q", "--no-header",
         "-p", "no:cacheprovider", "-o", "addopts="],
        capture_output=True,
        text=True,
        timeout=3000,
        cwd=os.path.dirname(os.path.dirname(__file__)),
        env=env,
    )
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-4000:])
    assert proc.returncode == 0, "distributed cases failed (see output)"


def test_multihost_two_process_msm():
    """REAL jax.distributed bootstrap: 2 localhost processes x 2 virtual
    CPU devices = one 4-device global mesh, data-parallel MSM sharded
    across processes, oracle-checked in each (dist/mesh.py
    init_distributed's only exercise without several hosts)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=1200)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(f"--- proc {pid} output ---\n{out[-4000:]}")
        assert p.returncode == 0, f"worker {pid} failed"
        assert "oracle-exact" in out
