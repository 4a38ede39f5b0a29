"""Read simulators + subsetting modes (exp0 toolchain)."""

import numpy as np
import pytest

from conftest import random_dna
from khoice_tpu.mems.extract import Feature
from khoice_tpu.sim import (
    grab_reads,
    sim_illumina,
    sim_ont,
    subset_features_half_mems,
    subset_features_mems,
    subset_reads_kmers,
)


def test_sim_illumina_deterministic(rng):
    seqs = [random_dna(rng, 5000)]
    r1 = sim_illumina(seqs, np.random.default_rng(7))
    r2 = sim_illumina(seqs, np.random.default_rng(7))
    assert r1 == r2
    assert all(len(r) == 150 for r in r1)
    # 10x coverage
    assert len(r1) == int(np.ceil(10.0 * 5000 / 150))


def test_sim_ont_length_range(rng):
    seqs = [random_dna(rng, 20000)]
    reads = sim_ont(seqs, np.random.default_rng(7))
    assert reads
    # indels shift lengths slightly around [900, 1100]
    assert all(700 < len(r) < 1300 for r in reads)


def test_illumina_positional_profile_statistics(rng):
    """Error rate matches the configured mean and RISES toward the 3' end
    (ART HS25 profile shape) — measured by aligning reads back to their
    error-free source positions."""
    from khoice_tpu.sim.error_models import IlluminaProfile

    prof = IlluminaProfile.hs25_like(150, mean_rate=0.01)
    seq = random_dna(rng, 4000)
    g = np.random.default_rng(5)
    n_reads, per_pos_err, total = 4000, np.zeros(150), 0
    src = np.frombuffer(seq.encode(), dtype=np.uint8)
    for _ in range(n_reads):
        s = int(g.integers(0, 4000 - 150 + 1))
        read = sim_illumina([seq[s : s + 150]], g, coverage=1.0, profile=prof)[0]
        diff = np.frombuffer(read.encode(), dtype=np.uint8) != src[s : s + 150]
        per_pos_err += diff
        total += diff.sum()
    mean_rate = total / (n_reads * 150)
    assert 0.008 < mean_rate < 0.012, mean_rate
    # 3' third must be substantially noisier than the 5' third
    assert per_pos_err[100:].mean() > 2.0 * per_pos_err[:50].mean()


def test_ont_hmm_accuracy_calibration():
    """Mean per-base error of the default quality HMM matches
    1-accuracy_mean within 20%, and errors are BURSTY (adjacent error
    correlation well above the iid expectation)."""
    from khoice_tpu.sim.error_models import QualityHmm

    acc = 0.95
    model = QualityHmm.from_accuracy(acc)
    g = np.random.default_rng(11)
    quals = model.sample_qualities(g, 200_000)
    errp = model.error_probs(quals)
    err = g.random(errp.shape[0]) < errp
    rate = err.mean()
    assert 0.8 * (1 - acc) < rate < 1.2 * (1 - acc), rate
    # burstiness: P(err_{i+1} | err_i) >> P(err) for an HMM with bursts
    cond = (err[1:] & err[:-1]).sum() / max(err[:-1].sum(), 1)
    assert cond > 2.0 * rate, (cond, rate)


def test_ont_model_file_roundtrip(tmp_path):
    """write_model_file -> from_pbsim_file roundtrips, drives sim_ont, and
    a malformed file raises with the format contract in the message."""
    import pytest as _pytest

    from khoice_tpu.sim.error_models import QualityHmm, write_model_file

    model = QualityHmm.from_accuracy(0.9)
    path = tmp_path / "R95.model"
    write_model_file(str(path), model)
    loaded = QualityHmm.from_pbsim_file(str(path))
    assert np.allclose(loaded.trans, model.trans, atol=1e-6)
    assert np.allclose(loaded.emit, model.emit, atol=1e-6)

    seqs = ["".join("ACGT"[i % 4] for i in range(3000))]
    reads = sim_ont(seqs, np.random.default_rng(3), length_min=400,
                    length_max=600, model_file=str(path))
    assert reads and all(300 < len(r) < 700 for r in reads)

    bad = tmp_path / "bad.model"
    bad.write_text("3 0.5 0.5\n")
    with _pytest.raises(ValueError, match="transitions"):
        QualityHmm.from_pbsim_file(str(bad))


def test_ont_length_distribution_in_bounds():
    seqs = ["".join("ACGT"[i % 4] for i in range(30000))]
    g = np.random.default_rng(9)
    reads = sim_ont(seqs, g, accuracy_mean=0.99, length_min=900, length_max=1100)
    # with 1% error the indel drift is small; raw draw is in [900, 1100]
    lens = np.array([len(r) for r in reads])
    assert lens.min() > 850 and lens.max() < 1150
    assert 950 < lens.mean() < 1050


def test_grab_reads(rng):
    seqs = [random_dna(rng, 2000), random_dna(rng, 2000)]
    reads = grab_reads(seqs, np.random.default_rng(3), num_reads=50, read_length=80)
    assert len(reads) == 50
    assert all(len(r) == 80 for r in reads)


def test_subset_kmers_budget(rng):
    reads = [random_dna(rng, 100) for _ in range(100)]
    out = subset_reads_kmers(reads, np.random.default_rng(1), 500, 31)
    total = sum(len(r) - 30 for r in out)
    assert total >= 500
    # minimal: removing the last read must drop below budget
    assert total - (len(out[-1]) - 30) < 500
    with pytest.raises(ValueError):
        subset_reads_kmers(reads[:2], np.random.default_rng(1), 10**6, 31)


def _features(n):
    return [
        Feature(name=f"read_{i}_mem_{i}_length_50", seq="A" * 50, length=50, read_num=i, kind="mem")
        for i in range(n)
    ]


def test_subset_half_mems():
    feats = _features(50)
    out = subset_features_half_mems(feats, np.random.default_rng(0), 20)
    assert len(out) == 50  # under the +10000 buffer, all kept
    assert len({f.name for f in out}) == 50


def test_subset_mems_budget():
    feats = _features(100000)
    out = subset_features_mems(feats, np.random.default_rng(0), 1000, total_ref_length=4**10)
    per = 50 - 10  # len - log4(4^10)
    assert len(out) == int(np.ceil((1000 + 10000) / per))


def test_pbsim2_hmm_model_file(tmp_path):
    """A hand-written pbsim2-layout FIC-HMM model (sparse IP/TP/EP
    triples, the `--hmm_model R95.model` family the reference invokes at
    prepare_data.smk:97-98) loads via the layout sniffer, reproduces its
    matrices, and drives sim_ont at the model's own calibrated error
    rate; malformed keyword files fail naming the contract."""
    import pytest as _pytest

    from khoice_tpu.sim.error_models import QualityHmm, load_model_file

    # 2-state bursty chain, 1-based states: state 1 emits q=20
    # (err 0.01), state 2 q=7 (err ~0.1995); stationary = (5/6, 1/6)
    lines = [
        "# hand-written pbsim2-layout model",
        "IP 1 0.8", "IP 2 0.2",
        "TP 1 1 0.98", "TP 1 2 0.02",
        "TP 2 1 0.10", "TP 2 2 0.90",
        "EP 1 20 1.0",
        "EP 2 7 0.5", "EP 2 7 0.5",  # duplicates accumulate
    ]
    path = tmp_path / "R95.model"
    path.write_text("\n".join(lines) + "\n")

    m = load_model_file(str(path))
    assert isinstance(m, QualityHmm)
    assert np.allclose(m.trans, [[0.98, 0.02], [0.10, 0.90]])
    assert np.allclose(m.init, [0.8, 0.2])
    assert m.emit[0, 20] == 1.0 and m.emit[1, 7] == 1.0

    # calibration: long-walk mean error ~= stationary-weighted rate
    quals = m.sample_qualities(np.random.default_rng(2), 100_000)
    pi = np.array([0.10, 0.02]) / 0.12  # stationary of the chain
    want = pi[0] * 10 ** (-20 / 10) + pi[1] * 10 ** (-7 / 10)
    got = m.error_probs(quals).mean()
    assert 0.85 * want < got < 1.15 * want, (got, want)

    seqs = ["".join("ACGT"[(i * 3 + i // 7) % 4] for i in range(20000))]
    reads = sim_ont(seqs, np.random.default_rng(4), length_min=400,
                    length_max=600, model_file=str(path))
    assert reads and all(300 < len(r) < 700 for r in reads)

    # IP-less file: init falls back to the stationary distribution
    path2 = tmp_path / "noip.model"
    path2.write_text("\n".join(l for l in lines if not l.startswith("IP")) + "\n")
    m2 = load_model_file(str(path2))
    assert np.allclose(m2.init, pi, atol=1e-8)

    # unknown keyword / arity fails loudly with the contract in the text
    bad = tmp_path / "bad2.model"
    bad.write_text("IP 1 1.0\nXX 1 2 0.5\n")
    with _pytest.raises(ValueError, match="IP <state>"):
        load_model_file(str(bad))
    bad.write_text("TP 1 1 1.0\nEP 1 200 1.0\n")
    with _pytest.raises(ValueError, match="outside"):
        load_model_file(str(bad))
    bad.write_text("TP 1 1 0.4\nEP 1 20 1.0\n")
    with _pytest.raises(ValueError, match="mass"):
        load_model_file(str(bad))


def test_pbsim1_model_qc_table(tmp_path):
    """A hand-written pbsim1 model_qc table (rows: <accuracy int> then
    quality-code probabilities) loads via the layout sniffer, binds to
    the requested accuracy-mean, and drives sim_ont with a statistically
    calibrated error rate; malformed tables fail naming the contract."""
    import pytest as _pytest

    from khoice_tpu.sim.error_models import ModelQc, load_model_file

    # accuracy-95 row: all mass on q=13 -> error = 10^-1.3 ~ 0.0501;
    # other rows present to exercise nearest-row selection
    k = 24
    rows = {90: 10, 95: 13, 99: 20}
    lines = ["# hand-written pbsim1-style model_qc table"]
    for acc, q in rows.items():
        p = ["0"] * k
        p[q] = "1.0"
        lines.append(f"{acc} " + " ".join(p))
    path = tmp_path / "model_qc_clr"
    path.write_text("\n".join(lines) + "\n")

    m = load_model_file(str(path), accuracy_mean=0.95)
    assert isinstance(m, ModelQc)
    quals = m.sample_qualities(np.random.default_rng(0), 1000)
    assert set(quals.tolist()) == {13}
    # nearest-row selection: 0.98 -> accuracy-99 row (q=20)
    assert set(m.bind(0.98).sample_qualities(
        np.random.default_rng(0), 100).tolist()) == {20}

    seqs = ["".join("ACGT"[(i * 7 + i // 5) % 4] for i in range(60000))]
    g = np.random.default_rng(5)
    reads = sim_ont(seqs, g, accuracy_mean=0.95, length_min=900,
                    length_max=1100, model_file=str(path))
    assert len(reads) >= 400
    # realized per-base difference rate ~ 0.0501 (q=13); alignment-free
    # proxy: sampled error probability equals 10^(-13/10) exactly, and
    # read lengths drift by ins/del at that rate
    err = 10 ** (-13 / 10)
    lens = np.array([len(r) for r in reads])
    # ins and del rates are err * ratio/(sum); R9.5 ratio 23:31:46 ->
    # net drift = err * (31 - 46) / 100 per base
    drift = err * (31 - 46) / 100
    mean_expected = 1000 * (1 + drift)
    assert abs(lens.mean() - mean_expected) < 12, lens.mean()

    bad = tmp_path / "bad_qc"
    bad.write_text("95 0.4 0.2\n99 0.5 0.5 0.5\n")
    with _pytest.raises(ValueError, match="inconsistent row widths|sums to"):
        ModelQc.from_file(str(bad))

    neg = tmp_path / "neg_qc"
    neg.write_text("150 0.5 0.5 0.0\n")
    with _pytest.raises(ValueError, match="outside"):
        ModelQc.from_file(str(neg))


def test_batch_hmm_qualities_match_naive_walk():
    """The vectorized state walks (2-state const/flip composition AND the
    >2-state candidate-table path) must equal the naive sequential HMM
    walk bit for bit under the same RNG stream."""
    from khoice_tpu.sim.error_models import MAX_Q, QualityHmm, _batch_hmm_qualities

    def naive(model, rng, n_reads, length):
        s = model.trans.shape[0]
        ctrans = np.cumsum(model.trans, axis=1)
        cemit = np.cumsum(model.emit, axis=1)
        states = np.empty((n_reads, length), np.int64)
        states[:, 0] = rng.choice(s, size=n_reads, p=model.init)
        u = rng.random((n_reads, length))
        for t in range(1, length):
            states[:, t] = np.minimum(
                (u[:, t, None] > ctrans[states[:, t - 1]]).sum(1), s - 1
            )
        ue = rng.random((n_reads, length))
        quals = np.empty((n_reads, length), np.int64)
        for t in range(length):
            quals[:, t] = (ue[:, t, None] > cemit[states[:, t]]).sum(1)
        return np.minimum(quals, MAX_Q - 1).astype(np.int8)

    m2 = QualityHmm.from_accuracy(0.95)
    trans3 = np.array([[0.9, 0.08, 0.02], [0.2, 0.7, 0.1], [0.3, 0.3, 0.4]])
    emit3 = np.zeros((3, MAX_Q))
    emit3[0, 25] = 1.0
    emit3[1, 12] = 0.5
    emit3[1, 13] = 0.5
    emit3[2, 3] = 1.0
    m3 = QualityHmm(trans=trans3, emit=emit3, init=np.array([0.5, 0.3, 0.2]))
    for m in (m2, m3):
        want = naive(m, np.random.default_rng(11), 40, 200)
        got = _batch_hmm_qualities(m, np.random.default_rng(11), 40, 200)
        np.testing.assert_array_equal(got, want)
