"""Test configuration: force CPU backend with 8 virtual devices.

Multi-chip sharding logic is validated on a fake 8-device CPU mesh
(XLA --xla_force_host_platform_device_count), per the project test strategy
(SURVEY.md section 4). Must run before jax is imported anywhere.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# The suite runs on the CPU backend (the tier-1 command sets
# JAX_PLATFORMS=cpu); pinning the default device as well keeps a run on a
# machine with a GPU off the card.  Tests marked `gpu` move themselves onto
# the card through the `gpu` fixture.
jax.config.update("jax_default_device", jax.devices("cpu")[0])
# NO persistent compile cache for the suite: jaxlib's XLA:CPU executable
# serialization segfaulted twice inside
# compilation_cache.put_executable_and_time while writing large streaming
# programs (and separately, AOT artifacts loaded across jaxlib builds can
# SIGILL on host-feature mismatch).  The suite pays recompiles instead;
# the CLI keeps its own cache (khoice_tpu/utils/compile_cache.py).


def cpu_devices(n=8):
    return jax.devices("cpu")[:n]

import random

import numpy as np
import pytest


@pytest.fixture
def rng():
    return random.Random(1234)


@pytest.fixture
def nprng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU, made the default device for the test; skips where
    JAX sees none.  Decided here, at run time, so every xdist worker
    collects the same tests."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "python -m pytest tests/test_gpu.py -m gpu -n 0)")
    with jax.default_device(gpus[0]):
        yield gpus[0]


def random_dna(rng, n, n_prob=0.0):
    alphabet = "ACGT"
    out = []
    for _ in range(n):
        if n_prob > 0 and rng.random() < n_prob:
            out.append("N")
        else:
            out.append(alphabet[rng.randrange(4)])
    return "".join(out)


def pytest_collection_modifyitems(config, items):
    """Run the streaming tests FIRST.

    The XLA:CPU compiler segfaulted three times compiling streaming's
    large programs only after ~200 prior tests' executables had
    accumulated in-process (fresh-process runs of the same tests always
    pass); compiling the big programs before the long tail sidesteps
    the accumulation. Stable sort keeps all other ordering."""
    items.sort(key=lambda it: 0 if "test_streaming" in it.nodeid else 1)
