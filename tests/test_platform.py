"""Platform plumbing: compile-cache placement, mesh and device checks, the
memory guards, and the GPU-only entry points refusing the CPU."""

import json
import os
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from khoice_tpu.utils import compile_cache  # noqa: E402


# --- compile cache ----------------------------------------------------------


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "mine"))
    assert compile_cache.compile_cache_dir() == str(tmp_path / "mine")


def test_cache_dir_default_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.compile_cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as fd:
        assert ".jax_cache/" in fd.read().split()


def test_cache_dir_independent_of_cwd(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    here = compile_cache.compile_cache_dir()
    monkeypatch.chdir(tmp_path)
    assert compile_cache.compile_cache_dir() == here


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_compile_cache_updates_jax_config(monkeypatch, tmp_path, env_set):
    """jax is already imported here, so the config (not just the
    environment) must point at the cache."""
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = compile_cache.DEFAULT_CACHE_DIR
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.environ["JAX_COMPILATION_CACHE_DIR"] == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# --- meshes and device counts -----------------------------------------------


def test_make_mesh_raises_on_too_few_devices():
    from khoice_tpu.dist.mesh import make_mesh

    n = len(jax.devices())
    with pytest.raises(ValueError, match="requested"):
        make_mesh(n + 1)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_make_mesh_takes_first_n_devices(n):
    from khoice_tpu.dist.mesh import AXIS, make_mesh

    mesh = make_mesh(n)
    assert mesh.axis_names == (AXIS,)
    assert list(mesh.devices.flat) == jax.devices()[:n]


def test_dryrun_multichip_raises_instead_of_falling_back():
    import __graft_entry__ as graft

    with pytest.raises(ValueError, match="requested"):
        graft.dryrun_multichip(len(jax.devices()) + 1)


# --- memory guards ----------------------------------------------------------


class _FakeDevice:
    platform = "gpu"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize(
    "stats,n2,too_big",
    [
        (None, 10**12, False),                   # CPU: no limit reported
        ({}, 10**12, False),
        ({"bytes_limit": 0}, 10**12, False),
        ({"bytes_limit": 60 << 30}, 320_000_000, False),   # realistic exp2
        ({"bytes_limit": 60 << 30}, 1_000_000_000, True),
        ({"bytes_limit": 16 << 30}, 320_000_000, True),
    ],
)
def test_classify_scan_guard(stats, n2, too_big):
    from khoice_tpu.engine.ksweep_classify import _scan_too_big

    assert _scan_too_big(n2, _FakeDevice(stats)) is too_big


def test_classify_guard_reads_the_computing_device(monkeypatch, rng):
    """The guard is asked about the device holding the packed arrays, and
    a refusal sends every k to the per-k path."""
    from conftest import random_dna
    from khoice_tpu.engine import ksweep_classify as kc
    from khoice_tpu.io.packing import encode_records

    seen = []

    def guard(n2, device):
        seen.append(device)
        return True

    monkeypatch.setattr(kc, "_scan_too_big", guard)
    members = [encode_records([random_dna(rng, 200)]) for _ in range(3)]
    counts, rem = kc.pivot_rest_counts_sweep(members, [9, 11, 13])
    assert counts == {} and rem == [9, 11, 13]
    assert seen == [jax.config.jax_default_device or jax.devices()[0]]


@pytest.mark.parametrize(
    "stats,want",
    [
        ({"bytes_limit": 80 << 30}, int((80 << 30) * 0.85)),
        ({"bytes_limit": 0}, 64 << 30),
        (None, 64 << 30),
    ],
)
def test_default_device_budget(monkeypatch, stats, want):
    from khoice_tpu.engine import streaming

    monkeypatch.setattr(streaming.jax, "devices", lambda: [_FakeDevice(stats)])
    assert streaming.default_device_budget_bytes() == want


# --- GPU-only entry points refuse the CPU -----------------------------------


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_chip_smoke_refuses_cpu(capsys, argv):
    import chip_smoke

    assert jax.devices()[0].platform == "cpu"
    rc = chip_smoke.main(argv)
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok"' not in out


def test_bench_refuses_cpu(capsys):
    import bench

    assert bench.main() != 0
    assert "Mkmer" not in capsys.readouterr().out


def test_smoke_world_is_seeded():
    import chip_smoke

    a, b = chip_smoke.small_world(), chip_smoke.small_world()
    assert a == b
    assert chip_smoke.small_world(seed=12) != a
    assert sorted(a) == [1, 2] and all(len(g) == 3 for g in a.values())
    seq = a[1]["genome_1_0"][0]
    assert "N" in seq and "A" * 2000 in seq


def test_smoke_world_files_round_trip(tmp_path):
    """The small world written to disk reads back through the CLI's
    database loader unchanged."""
    import chip_smoke
    from khoice_tpu.pipelines.exp0 import load_database_dir

    db = chip_smoke.small_world(length=3000)
    root = chip_smoke.write_database(db, str(tmp_path / "db"))
    assert load_database_dir(root) == db
    assert json.dumps(chip_smoke.SMALL_KS)
