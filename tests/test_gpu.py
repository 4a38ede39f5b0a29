"""Checks that need the card: chip_smoke.py's phases under pytest, on a
smaller realistic world.  They skip where JAX sees no GPU; on the card run

    python -m pytest tests/test_gpu.py -m gpu -n 0

(one process: a second JAX process on the card fails for want of memory).
"""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu

WORLD_MBP = 1.0  # 4 datasets x 8 genomes x 1 Mbp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    if not any(d.platform == "gpu" for d in jax.devices()):
        pytest.skip("needs an NVIDIA GPU")
    root = str(tmp_path_factory.mktemp("world"))
    return chip_smoke.realistic_world(root, mbp=WORLD_MBP)


def test_gpu_small_world_matches_oracle(gpu, tmp_path):
    chip_smoke.phase_small_world(str(tmp_path))


def test_gpu_realistic_exp1_sweep_matches_per_k(gpu, world, tmp_path):
    res = chip_smoke.phase_realistic_exp1(str(tmp_path), world)
    assert res["cross_checked_ks"] == list(chip_smoke.CROSS_KS)


def test_gpu_classify_sweep_matches_per_k(gpu, world):
    chip_smoke.phase_classify(world)


def test_gpu_streaming_matches_incore(gpu, world, tmp_path):
    incore = str(tmp_path / "incore")
    chip_smoke._cli(["--exp-type", 1, "--database-root", world,
                     "--work-root", incore])
    chip_smoke.phase_streaming(str(tmp_path / "p4"), world, incore,
                               budget_gb=0.25)
