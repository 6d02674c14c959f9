"""chip_smoke.py's --multi phase on 4 virtual CPU devices.

It runs in a child process: collectives corrupt the XLA:CPU heap (see
tests/test_dist.py).  The pipeline's MSM has the dp MSM's size, so the
child compiles one distributed MSM program.
"""
import os
import subprocess
import sys


def test_phase_multi_on_4_cpu_devices():
    code = (
        "import jax, chip_smoke\n"
        "chip_smoke.phase_multi(chip_smoke.Meter(), jax.devices('cpu')[:4],"
        " curve='bn254', msm_logn=6, ntt_logn=6, pipe_classes=7,"
        " window_bits=4)\n"
        "print('multi ok')\n"
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=1200, cwd=root, env=env)
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-4000:])
    assert proc.returncode == 0
    assert "multi ok" in proc.stdout
    # each output buffer is reported on all four devices
    assert proc.stdout.count("TFRT_CPU_3") >= 3
