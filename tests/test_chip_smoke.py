"""chip_smoke.py's phases at tiny sizes on the CPU.

The script runs these phases at full width on the GPU; here each runs
through the same clients and oracles at a size the CPU compiles quickly
(BN254 where the curve does not matter).  The mesh phase is in
test_chip_smoke_multi.py.
"""
import os

import pytest

import chip_smoke
from blaze_tpu.msm import MSMConfig


@pytest.fixture(scope="module")
def meter():
    return chip_smoke.Meter()


def test_warm_batch_s():
    # the first yield carries the compile, the last is the drain
    assert chip_smoke.warm_batch_s([40.0, 50.0, 60.0, 70.0, 80.0, 81.0]) == 10.0
    with pytest.raises(ValueError):
        chip_smoke.warm_batch_s([1.0, 2.0])


def test_main_fails_without_gpu(capsys, monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_phase_poseidon(meter):
    chip_smoke.phase_poseidon(meter, height=3, nsample=8, full_height=2)


def test_phase_ntt(meter):
    chip_smoke.phase_ntt(meter, field="bn254_fr", logn=6, nsample=16, nnz=4)


def test_phase_msm(meter):
    chip_smoke.phase_msm(meter, curve="bn254", logn=9, stream_logn=7,
                         config=MSMConfig(chunk_log2=5))


def test_phase_pipeline(meter):
    chip_smoke.phase_pipeline(meter, curve="bn254", ntt_logn=6, msm_logn=5,
                              nbatches=3)
