"""Configuration for khoice-tpu experiments.

Single dataclass replacing the reference's config/config.yaml:1-15 +
hardcoded grids (workflow/Snakefile:36,39). All reference knobs carried
over; mesh/engine knobs are new (engine-specific).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence


def default_k_values() -> List[int]:
    """The reference k grid: 7..30 step 1, then 34..49 step 3
    (workflow/Snakefile:36)."""
    return list(range(7, 31)) + list(range(34, 50, 3))


def default_t_values() -> List[int]:
    """Threshold grid 1,5,10,...,30 (workflow/Snakefile:39)."""
    return [1] + list(range(5, 35, 5))


@dataclasses.dataclass
class KhoiceConfig:
    # --- reference-equivalent knobs (config/config.yaml) ---
    work_root: str = "."
    database_root: str = ""
    exp_type: int = 1
    num_datasets: int = 4
    num_trials: int = 1
    curr_trial: int = 1
    out_pivot: bool = False
    threshold: int = 15
    kmers_per_dataset: int = 25_000_000
    non_kmers_per_dataset: int = 25_000_000
    num_reads_per_dataset: int = 10_000
    k_values: List[int] = dataclasses.field(default_factory=default_k_values)
    t_values: List[int] = dataclasses.field(default_factory=default_t_values)
    # reference config/config.yaml:11,15 — pbsim HMM model path (forwarded to
    # the ONT read simulator as its error-profile seed material) and the
    # trial-info directory for pinned pivot choices
    pbsim_model: str = ""
    trial_info_dir: str = ""

    # --- counter semantics (KMC defaults + reference overrides) ---
    count_cs: int = 255          # kmc default counter cap
    union_cs: int = 5000         # reference passes -cs5000 on unions
    hist_cx: int = 10000         # kmc_tools histogram default upper bound

    # --- engine knobs (new, engine-specific) ---
    seed: int = 0                # seeded randomness (pivot choice, tie-breaks)
    mesh_shards: int = 1         # devices along the k-mer key-range axis
    read_sim_seed: int = 0
    # device memory budget in GiB for the exp1 sweep (0 = auto-detect from
    # the accelerator); groups beyond it stream with bounded memory, the
    # `kmc -m64` role (engine/streaming.py)
    device_budget_gb: float = 0.0

    @staticmethod
    def from_yaml(path: str) -> "KhoiceConfig":
        import yaml  # lazy; pyyaml is available in the image

        with open(path) as fd:
            raw = yaml.safe_load(fd) or {}
        mapping = {
            "WORK_ROOT": "work_root",
            "DATABASE_ROOT": "database_root",
            "EXP_TYPE": "exp_type",
            "NUM_DATASETS": "num_datasets",
            "NUM_TRIALS": "num_trials",
            "CURR_TRIAL": "curr_trial",
            "OUT_PIVOT": "out_pivot",
            "THRESHOLD": "threshold",
            "KMERS_PER_DATASET": "kmers_per_dataset",
            "NON_KMERS_PER_DATASET": "non_kmers_per_dataset",
            "NUM_READS_PER_DATASET": "num_reads_per_dataset",
            "PBSIM_MODEL": "pbsim_model",
            "TRIAL_INFO_DIR": "trial_info_dir",
        }
        kwargs = {}
        for key, val in raw.items():
            if key in mapping:
                kwargs[mapping[key]] = val
            elif key.lower() in {f.name for f in dataclasses.fields(KhoiceConfig)}:
                kwargs[key.lower()] = val
        return KhoiceConfig(**kwargs)
