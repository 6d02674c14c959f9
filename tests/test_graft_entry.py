"""Execute the __graft_entry__ dry run, mesh work isolated in a subprocess.

`dryrun_multichip(8, "cpu")` rehearses the multi-device step on 8 virtual
CPU devices.  The dry run creates a mesh and runs collectives; those
executables corrupt the XLA:CPU process heap (see tests/test_dist.py
docstring), so it runs in a child process.
"""
import os
import subprocess
import sys


def test_dryrun_multichip_8():
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as ge; ge.dryrun_multichip(8, 'cpu')"],
        capture_output=True,
        text=True,
        timeout=2400,
        cwd=os.path.dirname(os.path.dirname(__file__)),
        env=env,
    )
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-4000:])
    assert proc.returncode == 0, "dryrun_multichip(8) failed (see output)"
    assert "dryrun_multichip OK" in proc.stdout
