"""Read-simulator error models: quality-HMM (pbsim role) + positional
profiles (ART role).

The reference simulates reads with two external C++ tools
(workflow/rules/prepare_data.smk:81,97-98):

- `art_illumina -ss HS25 -l 150`: Illumina reads whose substitution rate
  follows an empirical PER-POSITION quality profile (errors rise toward
  the read's 3' end).
- `pbsim --hmm_model R95.model --accuracy-mean 0.95`: ONT reads whose
  per-base qualities come from an HMM (config/config.yaml:11), giving the
  BURSTY error structure real nanopore reads have; error types follow
  pbsim2's sub:ins:del difference ratio (23:31:46 by default).

This module reproduces both structures natively and seedably:

- IlluminaProfile: per-position substitution probability ramp.
- QualityHmm: Markov chain over states, each emitting Phred qualities;
  error probability per base = 10^(-q/10); types drawn by the difference
  ratio. `from_pbsim_file` parses an on-disk model (whitespace floats:
  n_states, n_states^2 transitions, n_states x 94 emissions — the
  documented contract here; a file that doesn't match raises with the
  expectation spelled out), `from_accuracy` builds a 2-state bursty model
  calibrated so the stationary mean error equals 1-accuracy.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

MAX_Q = 94  # Phred quality alphabet 0..93 (Sanger '!'..'~')

# pbsim2's default sub:ins:del difference ratio for R9.5 chemistry
DEFAULT_DIFFERENCE_RATIO = (23, 31, 46)


@dataclasses.dataclass
class IlluminaProfile:
    """Per-position substitution probabilities (ART quality-profile role)."""

    pos_error: np.ndarray  # [read_len] float64

    @classmethod
    def hs25_like(cls, read_len: int = 150, mean_rate: float = 0.0015,
                  end_factor: float = 6.0) -> "IlluminaProfile":
        """HS25-shaped ramp: flat near the 5' start, rising ~end_factor x
        by the 3' end, scaled so the mean equals mean_rate."""
        x = np.linspace(0.0, 1.0, read_len)
        shape = 1.0 + (end_factor - 1.0) * x**3
        shape *= mean_rate / shape.mean()
        return cls(pos_error=shape)

    @property
    def read_len(self) -> int:
        return int(self.pos_error.shape[0])

    def sample_error_positions(self, rng: np.random.Generator) -> np.ndarray:
        """Indices of substitution errors for one read."""
        return np.nonzero(rng.random(self.read_len) < self.pos_error)[0]


@dataclasses.dataclass
class QualityHmm:
    """HMM over Phred qualities (pbsim2 --hmm_model role)."""

    trans: np.ndarray      # [S, S] row-stochastic
    emit: np.ndarray       # [S, MAX_Q] row-stochastic quality emissions
    init: np.ndarray       # [S]
    difference_ratio: Tuple[int, int, int] = DEFAULT_DIFFERENCE_RATIO

    def __post_init__(self):
        s = self.trans.shape[0]
        assert self.trans.shape == (s, s) and self.emit.shape[0] == s
        assert np.allclose(self.trans.sum(1), 1.0, atol=1e-6)
        assert np.allclose(self.emit.sum(1), 1.0, atol=1e-6)

    @classmethod
    def from_pbsim_file(cls, path: str,
                        difference_ratio: Tuple[int, int, int] = DEFAULT_DIFFERENCE_RATIO
                        ) -> "QualityHmm":
        """Parse a quality-HMM model file.

        Expected contents (whitespace-separated numbers, '#' comments
        allowed): first an integer S (number of states), then S*S
        transition probabilities (row-major), then S*94 quality-emission
        probabilities (row-major). Anything else raises ValueError naming
        this contract, so an incompatible upstream model file fails
        loudly instead of silently missimulating.
        """
        nums = []
        with open(path) as fd:
            for line in fd:
                line = line.split("#", 1)[0]
                nums.extend(float(tok) for tok in line.split())
        if not nums:
            raise ValueError(f"{path}: empty model file")
        s = int(nums[0])
        want = 1 + s * s + s * MAX_Q
        if s <= 0 or len(nums) != want:
            raise ValueError(
                f"{path}: expected <S> <S*S transitions> <S*{MAX_Q} emissions> "
                f"= {want if s > 0 else 'N'} numbers for S={s}, got {len(nums)}"
            )
        trans = np.array(nums[1 : 1 + s * s]).reshape(s, s)
        emit = np.array(nums[1 + s * s :]).reshape(s, MAX_Q)
        trans = trans / trans.sum(1, keepdims=True)
        emit = emit / emit.sum(1, keepdims=True)
        init = _stationary(trans)
        return cls(trans=trans, emit=emit, init=init,
                   difference_ratio=difference_ratio)

    @classmethod
    def from_pbsim2_file(cls, path: str,
                         difference_ratio: Tuple[int, int, int] = DEFAULT_DIFFERENCE_RATIO
                         ) -> "QualityHmm":
        """Parse pbsim2's `--hmm_model` FIC-HMM layout (the R95.model
        family the reference names, workflow/rules/prepare_data.smk:97-98).

        pbsim2 (Ono et al. 2021) stores its quality-score HMM as SPARSE
        keyword triples, one probability per line ('#' comments and blank
        lines allowed):

            IP <state> <prob>             initial probability of <state>
            TP <state> <state2> <prob>    transition <state> -> <state2>
            EP <state> <qual> <prob>      P(quality code <qual> | <state>)

        State ids may be 0- or 1-based (normalized to a dense 0-based
        range); omitted entries are zero; quality codes must lie in
        [0, 93].  Each state's TP and EP mass and the total IP mass must
        be ~1 (then renormalized exactly); a file with no IP lines takes
        the transition chain's stationary distribution.  Anything else
        raises ValueError naming this contract — NOTE: no pbsim2
        distribution exists in this zero-egress environment to
        byte-verify a shipped model against (the layout is reconstructed
        from pbsim2's published model description), so the parser is
        deliberately strict and fails loudly rather than missimulating.
        """
        ip: dict = {}
        tp: dict = {}
        ep: dict = {}
        with open(path) as fd:
            for ln, line in enumerate(fd, 1):
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                toks = line.split()
                kind = toks[0].upper()
                try:
                    if kind == "IP" and len(toks) == 3:
                        ip[int(toks[1])] = ip.get(int(toks[1]), 0.0) + float(toks[2])
                    elif kind == "TP" and len(toks) == 4:
                        key = (int(toks[1]), int(toks[2]))
                        tp[key] = tp.get(key, 0.0) + float(toks[3])
                    elif kind == "EP" and len(toks) == 4:
                        key = (int(toks[1]), int(toks[2]))
                        ep[key] = ep.get(key, 0.0) + float(toks[3])
                    else:
                        raise ValueError("unknown record")
                except ValueError as e:
                    raise ValueError(
                        f"{path}:{ln}: pbsim2 hmm_model lines are "
                        f"'IP <state> <p>' | 'TP <state> <state2> <p>' | "
                        f"'EP <state> <qual 0..{MAX_Q - 1}> <p>' ({e})"
                    ) from e
        states = sorted(
            set(ip)
            | {s for s, _ in tp} | {s2 for _, s2 in tp}
            | {s for s, _ in ep}
        )
        if not states or not tp or not ep:
            raise ValueError(
                f"{path}: pbsim2 hmm_model needs TP and EP records for at "
                "least one state (IP optional -> stationary distribution)"
            )
        remap = {s: i for i, s in enumerate(states)}
        S = len(states)
        trans = np.zeros((S, S))
        emit = np.zeros((S, MAX_Q))
        for (s, s2), p in tp.items():
            trans[remap[s], remap[s2]] = p
        for (s, q), p in ep.items():
            if not (0 <= q < MAX_Q):
                raise ValueError(
                    f"{path}: EP quality code {q} outside [0, {MAX_Q - 1}]"
                )
            emit[remap[s], q] = p
        for name, mat in (("TP", trans), ("EP", emit)):
            sums = mat.sum(1)
            if not np.all((sums > 0.9) & (sums < 1.1)):
                bad = states[int(np.argmax(np.abs(sums - 1.0)))]
                raise ValueError(
                    f"{path}: state {bad}'s {name} mass is {sums.min():.3f}"
                    f"..{sums.max():.3f}, not ~1 (rows are distributions)"
                )
        trans = trans / trans.sum(1, keepdims=True)
        emit = emit / emit.sum(1, keepdims=True)
        if ip:
            init = np.zeros(S)
            for s, p in ip.items():
                init[remap[s]] = p
            if not (0.9 < init.sum() < 1.1):
                raise ValueError(
                    f"{path}: IP mass {init.sum():.3f} is not ~1"
                )
            init = init / init.sum()
        else:
            init = _stationary(trans)
        return cls(trans=trans, emit=emit, init=init,
                   difference_ratio=difference_ratio)

    @classmethod
    def from_accuracy(cls, accuracy_mean: float = 0.95,
                      burst_error: float = 0.35,
                      p_enter_burst: float = 0.01,
                      p_exit_burst: float = 0.20,
                      difference_ratio: Tuple[int, int, int] = DEFAULT_DIFFERENCE_RATIO
                      ) -> "QualityHmm":
        """2-state bursty model calibrated to a target mean accuracy.

        The burst state's error rate is fixed; the normal state's rate is
        solved from the stationary distribution so the overall expected
        per-base error equals 1-accuracy_mean (clipped at tiny positive).
        """
        target = 1.0 - accuracy_mean
        pi_b = p_enter_burst / (p_enter_burst + p_exit_burst)
        pi_n = 1.0 - pi_b
        e_b = min(burst_error, 0.75)
        e_n = max((target - pi_b * e_b) / pi_n, 1e-4)
        trans = np.array(
            [[1 - p_enter_burst, p_enter_burst], [p_exit_burst, 1 - p_exit_burst]]
        )
        emit = np.zeros((2, MAX_Q))
        for row, e in ((0, e_n), (1, e_b)):
            q = -10.0 * np.log10(max(e, 1e-9))
            lo = int(np.clip(np.floor(q), 0, MAX_Q - 1))
            hi = min(lo + 1, MAX_Q - 1)
            frac = q - lo
            # split between neighbor qualities so the MEAN error is exact
            # in expectation (linear interp in q-space is close enough at
            # these magnitudes; the statistical test pins the outcome)
            emit[row, lo] = 1.0 - frac
            emit[row, hi] += frac
        init = np.array([pi_n, pi_b])
        return cls(trans=trans, emit=emit, init=init,
                   difference_ratio=difference_ratio)

    def sample_qualities(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """[n] int8 Phred qualities from one HMM walk."""
        s = self.trans.shape[0]
        states = np.empty(n, np.int64)
        if n == 0:
            return np.empty(0, np.int8)
        states[0] = rng.choice(s, p=self.init)
        # cumulative rows once; walk with uniforms (fast enough at 1kbp)
        ctrans = np.cumsum(self.trans, axis=1)
        u = rng.random(n)
        for i in range(1, n):
            # clamp: float cumsum tails can end below 1.0, and a uniform
            # draw above them would index past the last state
            states[i] = min(np.searchsorted(ctrans[states[i - 1]], u[i]), s - 1)
        cemit = np.cumsum(self.emit, axis=1)
        ue = rng.random(n)
        quals = np.array(
            [np.searchsorted(cemit[st], x) for st, x in zip(states, ue)], np.int8
        )
        return np.minimum(quals, MAX_Q - 1)

    def error_probs(self, quals: np.ndarray) -> np.ndarray:
        return np.power(10.0, -quals.astype(np.float64) / 10.0)


def _stationary(trans: np.ndarray) -> np.ndarray:
    vals, vecs = np.linalg.eig(trans.T)
    i = int(np.argmin(np.abs(vals - 1.0)))
    v = np.real(vecs[:, i])
    v = np.abs(v)
    return v / v.sum()


def write_model_file(path: str, model: QualityHmm) -> None:
    """Serialize a QualityHmm in the from_pbsim_file contract format."""
    s = model.trans.shape[0]
    with open(path, "w") as fd:
        fd.write(f"# khoice-tpu quality-HMM model (S, S*S trans, S*{MAX_Q} emit)\n")
        fd.write(f"{s}\n")
        for row in model.trans:
            fd.write(" ".join(f"{x:.8g}" for x in row) + "\n")
        for row in model.emit:
            fd.write(" ".join(f"{x:.8g}" for x in row) + "\n")


@dataclasses.dataclass
class ModelQc:
    """pbsim1 `--model_qc` quality-code table: P(quality | read accuracy).

    pbsim1 (Ono et al. 2013, the tool the reference's PBSIM_MODEL knob
    family comes from; its data/ ships model_qc_clr / model_qc_ccs)
    models per-base quality as an ACCURACY-CONDITIONED categorical
    instead of pbsim2's HMM: the sampler picks the table row matching
    the read's accuracy and draws qualities iid from it.  On-disk layout
    parsed here: one whitespace row per accuracy percent — a leading
    integer accuracy in [0, 100] followed by the probabilities of
    quality codes 0..K-1 (K <= 94; '#' comments allowed).  No real
    pbsim1 install exists in this zero-egress environment to byte-check
    against, so the parser is strict and fails loudly (naming this
    contract) on anything that doesn't match — never silently
    missimulating.
    """

    probs: np.ndarray    # [101, K]; rows not in the file are zero
    present: np.ndarray  # [101] bool
    accuracy: float = 0.95
    difference_ratio: Tuple[int, int, int] = DEFAULT_DIFFERENCE_RATIO

    @classmethod
    def from_file(cls, path: str,
                  difference_ratio: Tuple[int, int, int] = DEFAULT_DIFFERENCE_RATIO
                  ) -> "ModelQc":
        rows = []
        with open(path) as fd:
            for ln, line in enumerate(fd, 1):
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                toks = line.split()
                try:
                    acc = int(toks[0])
                    vals = [float(t) for t in toks[1:]]
                except ValueError as e:
                    raise ValueError(
                        f"{path}:{ln}: model_qc rows are '<accuracy int> "
                        f"<P(q=0)> ... <P(q=K-1)>' ({e})"
                    ) from e
                if not (0 <= acc <= 100) or not vals:
                    raise ValueError(
                        f"{path}:{ln}: accuracy {acc} outside [0, 100] or "
                        "no quality probabilities"
                    )
                rows.append((acc, vals))
        if not rows:
            raise ValueError(f"{path}: empty model_qc file")
        K = len(rows[0][1])
        if K > MAX_Q or any(len(v) != K for _, v in rows):
            raise ValueError(
                f"{path}: inconsistent row widths or K={K} > {MAX_Q} "
                "quality codes (model_qc rows all carry the same K)"
            )
        probs = np.zeros((101, K))
        present = np.zeros(101, bool)
        for acc, vals in rows:
            v = np.asarray(vals, float)
            s = v.sum()
            if not (0.9 <= s <= 1.1):
                raise ValueError(
                    f"{path}: accuracy-{acc} row sums to {s:.3f}, not ~1 "
                    "(model_qc rows are probability distributions)"
                )
            probs[acc] = v / s
            present[acc] = True
        return cls(probs=probs, present=present,
                   difference_ratio=difference_ratio)

    def bind(self, accuracy: float) -> "ModelQc":
        return dataclasses.replace(self, accuracy=float(accuracy))

    def _row(self) -> np.ndarray:
        target = int(round(np.clip(self.accuracy, 0.0, 1.0) * 100))
        idx = np.nonzero(self.present)[0]
        return self.probs[idx[np.argmin(np.abs(idx - target))]]

    def sample_qualities(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """[n] int8 Phred qualities iid from the bound accuracy's row."""
        row = self._row()
        c = np.cumsum(row)
        q = np.searchsorted(c, rng.random(n))
        return np.minimum(q, row.shape[0] - 1).astype(np.int8)

    def error_probs(self, quals: np.ndarray) -> np.ndarray:
        return np.power(10.0, -quals.astype(np.float64) / 10.0)


def load_model_file(path: str,
                    accuracy_mean: float = 0.95,
                    difference_ratio: Tuple[int, int, int] = DEFAULT_DIFFERENCE_RATIO):
    """Load a quality model file of ANY supported on-disk layout.

    Sniff on the first non-comment line: a leading IP/TP/EP keyword ->
    pbsim2's sparse FIC-HMM triples (QualityHmm.from_pbsim2_file, the
    layout the reference's `--hmm_model R95.model` names); a single
    integer -> the dense HMM layout (QualityHmm.from_pbsim_file); a row
    of <int> + >=2 floats -> pbsim1's model_qc table (ModelQc.from_file,
    bound to accuracy_mean).  Anything else raises naming the contracts."""
    first = None
    with open(path) as fd:
        for line in fd:
            line = line.split("#", 1)[0].strip()
            if line:
                first = line.split()
                break
    if first is None:
        raise ValueError(f"{path}: empty model file")
    if first[0].upper() in ("IP", "TP", "EP"):
        return QualityHmm.from_pbsim2_file(path, difference_ratio)
    if len(first) == 1:
        return QualityHmm.from_pbsim_file(path, difference_ratio)
    if len(first) >= 3:
        return ModelQc.from_file(path, difference_ratio).bind(accuracy_mean)
    raise ValueError(
        f"{path}: unrecognized model layout — expected pbsim2 IP/TP/EP "
        f"triples, the dense HMM contract (<S> then S*S transitions then "
        f"S*{MAX_Q} emissions), or pbsim1 model_qc rows "
        "(<accuracy int> <P(q=0)> ... <P(q=K-1)>)"
    )


def _batch_hmm_qualities(model: "QualityHmm", rng: np.random.Generator,
                         n_reads: int, length: int) -> np.ndarray:
    """[n_reads, length] int8 qualities from n_reads parallel HMM walks.

    Vectorized across reads (the per-read scalar walk made ONT
    simulation the wall-clock bottleneck of realistic-scale exp0: 50k
    reads x 1 kbp = 50M Python iterations)."""
    if n_reads == 0 or length == 0:
        return np.zeros((n_reads, length), np.int8)
    s = model.trans.shape[0]
    ctrans = np.cumsum(model.trans, axis=1)
    cemit = np.cumsum(model.emit, axis=1)
    states = np.empty((n_reads, length), np.int64)
    states[:, 0] = rng.choice(s, size=n_reads, p=model.init)
    u = rng.random((n_reads, length))
    if s == 2:
        states = _walk_two_state(states[:, 0], u, ctrans)
    else:
        # per-step work reduced to ONE row gather by precomputing, for
        # every (read, t, current state), the next state via per-state
        # inverse-CDF searchsorted (chunked so the [R, T, S] candidate
        # table stays under ~300 MB)
        chunk = max(1, int(3e8) // (length * s))
        for lo in range(0, n_reads, chunk):
            hi = min(lo + chunk, n_reads)
            cand = np.empty((hi - lo, length, s), np.int8)
            for st in range(s):
                cand[:, :, st] = np.minimum(
                    np.searchsorted(ctrans[st], u[lo:hi]), s - 1
                )
            for t in range(1, length):
                states[lo:hi, t] = np.take_along_axis(
                    cand[:, t, :], states[lo:hi, t - 1, None], 1
                )[:, 0]
    ue = rng.random((n_reads, length))
    # emission sampling vectorized per STATE (S tiny), not per position
    quals = np.empty((n_reads, length), np.int64)
    for st in range(s):
        m = states == st
        quals[m] = np.searchsorted(cemit[st], ue[m])
    return np.minimum(quals, MAX_Q - 1).astype(np.int8)


def _walk_two_state(x0: np.ndarray, u: np.ndarray, ctrans: np.ndarray) -> np.ndarray:
    """Fully vectorized 2-state HMM state walk (no per-step Python loop).

    From state s the next state is 1 iff u > ctrans[s, 0], so each step is
    one of four reset/parity ops on the current state — const0, const1,
    keep, flip — and op composition is associative: x_t equals the value
    set by the LAST const step at/before t, XOR the parity of flip steps
    since it (or x_0 XOR total flip parity if no const occurred).  All of
    that is cummax / cumsum / row gathers — O(R*T) with ~8 numpy passes,
    vs T sequential passes for the generic walk (the 1100-step loop was
    60% of realistic-scale exp0 wall time)."""
    r, t = u.shape
    t0, t1 = ctrans[0, 0], ctrans[1, 0]
    go1_from0 = u[:, 1:] > t0
    go1_from1 = u[:, 1:] > t1
    is_const = go1_from0 == go1_from1
    const_val = go1_from0  # value when both states map to the same next
    # non-const steps: from0 and from1 disagree; 'flip' iff from0 -> 1
    is_flip = (~is_const) & go1_from0
    # int16/int32 throughout: the walk is HBM..DRAM-bandwidth-bound on
    # ~18 full [R, T] passes (int64 temporaries doubled its wall time)
    idt = np.int16 if t < 32767 else np.int32
    fcum = np.cumsum(is_flip, axis=1, dtype=idt)
    ts = np.arange(1, t, dtype=idt)
    # last const step index (column in the [R, T-1] step arrays) + 1; 0 = none
    last = np.maximum.accumulate(np.where(is_const, ts, idt(0)), axis=1)
    have = last > 0
    lastc = np.maximum(last - 1, idt(0)).astype(idt)
    base = np.where(have, np.take_along_axis(const_val, lastc, 1), x0[:, None] == 1)
    f_at = np.where(have, np.take_along_axis(fcum, lastc, 1), idt(0))
    x = base ^ ((np.subtract(fcum, f_at) & 1) == 1)
    out = np.empty((r, t), np.int8)
    out[:, 0] = x0
    out[:, 1:] = x
    return out


def sample_qualities_batch(model, rng: np.random.Generator, n_reads: int,
                           length: int) -> np.ndarray:
    """[n_reads, length] qualities for either model kind."""
    if isinstance(model, ModelQc):
        row = model._row()
        c = np.cumsum(row)
        q = np.searchsorted(c, rng.random((n_reads, length)))
        return np.minimum(q, row.shape[0] - 1).astype(np.int8)
    return _batch_hmm_qualities(model, rng, n_reads, length)
