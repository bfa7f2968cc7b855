"""The plain reference judges hand-made SAM records as their two
sequences say."""
import numpy as np
import pytest

from wmbench.genome import BASES
from wmbench.reference import check as C

SC = {"a": 2, "b": 4, "q": 4, "e": 2}


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(8)
    chrom = rng.integers(0, 4, 2000).astype(np.uint8)
    t = chrom[100:600]
    q = t.copy()
    q[50] = (q[50] + 1) & 3  # one substitution
    q = np.concatenate([q[:201], [0, 1], q[201:300], q[303:]])  # 2I, 3D
    return chrom, q.astype(np.uint8)


def _line(name, flag, pos, cigar, seq, nm, ms, rname="chr1"):
    return [name, str(flag), rname, str(pos), "60", cigar, "*", "0", "0",
            seq.decode(), "*", f"NM:i:{nm}", f"ms:i:{ms}", "AS:i:0"]


def _bytes(codes):
    return BASES[codes].tobytes()


def test_walk_counts_edits_and_the_running_score(case):
    chrom, q = case
    ops, lens = C.parse_cigar("201M2I99M3D197M")
    mis, ins, dele, ms, introns = C.walk(q, chrom, 100, ops, lens, SC)
    assert (mis, ins, dele) == (1, 2, 3)
    # 200 matches - 1 mismatch, -(4+2*2), +99*2, -(4+2*3), +197*2
    assert ms == 200 * 2 - 4 - 8 + 198 - 10 + 394 == 970
    assert len(introns) == 0


def test_the_score_floors_at_zero():
    t = np.zeros(20, np.uint8)
    q = np.array([1] * 5 + [0] * 15, np.uint8)
    ops, lens = C.parse_cigar("20M")
    assert C.walk(q, t, 0, ops, lens, SC)[3] == 30


def _judge(lines, seq, origin, chrom, planted=None):
    return C.judge(lines, {"r": (seq, origin)}, ["chr1"], [chrom], SC,
                   planted)


@pytest.mark.parametrize("rev", [False, True])
def test_a_sound_record_passes(case, rev):
    chrom, q = case
    seq = _bytes(C.revcomp(q) if rev else q)
    line = _line("r", 16 if rev else 0, 101, "201M2I99M3D197M", _bytes(q),
                 6, 970)
    nums, _ = _judge([line], seq, (0, 100, 600, rev, True), chrom)
    assert nums["record_faults"] == 0
    assert nums["origin_miss_pct"] == 0 and nums["clipped_pct"] == 0


@pytest.mark.parametrize("field,value,why", [
    (11, "NM:i:5", "NM"), (12, "ms:i:969", "ms"),
    (5, "201M2I99M3D196M", "CIGAR"), (3, "1600", "outside"),
    (9, "A" * 499, "SEQ")])
def test_a_wrong_record_is_a_fault(case, field, value, why):
    chrom, q = case
    line = _line("r", 0, 101, "201M2I99M3D197M", _bytes(q), 6, 970)
    line[field] = value
    nums, j = _judge([line], _bytes(q), (0, 100, 600, False, True), chrom)
    assert nums["record_faults"] == 1, why


def test_a_read_with_no_record_is_a_fault(case):
    chrom, q = case
    nums, _ = _judge([], _bytes(q), (0, 100, 600, False, True), chrom)
    assert nums["record_faults"] == 1


def test_origin_misses_and_clips(case):
    chrom, q = case
    line = _line("r", 0, 101, "201M2I99M3D197M", _bytes(q), 6, 970)
    # the wrong strand misses its origin
    nums, _ = _judge([line], _bytes(q), (0, 100, 600, True, True), chrom)
    assert nums["origin_miss_pct"] == 100.0
    # a read of no unique origin is not asked for one
    nums, _ = _judge([line], _bytes(q), (0, 100, 600, True, False), chrom)
    assert nums["origin_miss_pct"] == 0.0
    # an unmapped primary misses; its bases are all clipped
    un = ["r", "4", "*", "0", "0", "*", "*", "0", "0", _bytes(q).decode(),
          "*"]
    nums, _ = _judge([un], _bytes(q), (0, 100, 600, False, True), chrom)
    assert nums["origin_miss_pct"] == 100.0 and nums["clipped_pct"] == 100.0
    assert nums["primary_clipped_pct"] == 100.0
    # a soft-clipped tail of 97 bases: 97 of 499 unaligned
    ops = "201M2I99M3D100M97S"
    ms = 200 * 2 - 4 - 8 + 198 - 10 + 200
    line = _line("r", 0, 101, ops, _bytes(q), 6, ms)
    nums, _ = _judge([line], _bytes(q), (0, 100, 600, False, True), chrom)
    assert nums["record_faults"] == 0
    assert nums["clipped_pct"] == pytest.approx(100 * 97 / 499)
    assert nums["primary_clipped_pct"] == pytest.approx(100 * 97 / 499)
    # a supplementary record aligns the tail: only the primary's share
    # stays clipped
    sup = _line("r", 0x800, 504, "402H97M", _bytes(q[402:]), 0, 194)
    nums, _ = _judge([line, sup], _bytes(q), (0, 100, 600, False, True),
                     chrom)
    assert nums["record_faults"] == 0 and nums["clipped_pct"] == 0.0
    assert nums["primary_clipped_pct"] == pytest.approx(100 * 97 / 499)


def test_introns_are_held_to_the_planted_ones(case):
    chrom, _ = case
    q = np.concatenate([chrom[100:200], chrom[500:600]])
    line = _line("r", 0, 101, "100M300N100M", _bytes(q), 0, 400)
    nums, _ = _judge([line], _bytes(q), (0, 100, 600, False, True), chrom,
                     planted={(0, 200, 500)})
    assert nums["record_faults"] == 0 and nums["intron_miss_pct"] == 0.0
    nums, _ = _judge([line], _bytes(q), (0, 100, 600, False, True), chrom,
                     planted={(0, 201, 500)})
    assert nums["intron_miss_pct"] == 100.0


DUAL = {"a": 2, "b": 4, "q": 4, "e": 2, "q2": 24, "e2": 1}


def _brute_best(x, y, sc):
    """The best global score with every gap length tried at every cell
    (no running maxima): a path's last step is an aligned pair or a gap
    run of any length (two runs of one direction in a row never beat one
    run, so allowing them changes nothing)."""
    def cost(n):
        c = sc["q"] + sc["e"] * n
        return min(c, sc["q2"] + sc["e2"] * n) if "q2" in sc else c
    n, m = len(x), len(y)
    H = [[None] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        for j in range(m + 1):
            if i == j == 0:
                H[i][j] = 0
                continue
            cand = [H[i - k][j] - cost(k) for k in range(1, i + 1)]
            cand += [H[i][j - k] - cost(k) for k in range(1, j + 1)]
            if i and j:
                cand.append(H[i - 1][j - 1] + (
                    sc["a"] if x[i - 1] == y[j - 1] else -sc["b"]))
            H[i][j] = max(cand)
    return H[n][m]


@pytest.mark.parametrize("sc", [DUAL, SC])
def test_best_scores_equal_a_brute_force_dp(sc):
    rng = np.random.default_rng(4)
    qs, ts, want = [], [], []
    for n in range(1, 16):
        x = rng.integers(0, 4, n).astype(np.uint8)
        y = x.copy()
        y = np.concatenate([y[:n // 2], rng.integers(0, 4, rng.integers(0, 30)),
                            y[n // 2:]]).astype(np.uint8)
        if n % 3 == 0:
            x, y = y, x
        qs.append(x)
        ts.append(y)
        want.append(_brute_best(x.tolist(), y.tolist(), sc))
    assert C.best_scores(qs, ts, sc).tolist() == want


def test_a_best_path_has_no_deficit_and_a_worse_one_has(case):
    chrom, q = case
    dp = {"bp": 120, "per_read": 3, "gaps": "single"}
    line = _line("r", 0, 101, "201M2I99M3D197M", _bytes(q), 6, 970)
    nums, j = C.judge([line], {"r": (_bytes(q), (0, 100, 600, False,
                                                 True))},
                      ["chr1"], [chrom], SC, None, dp)
    assert nums["record_faults"] == 0 and nums["dp_windows"] == 3
    assert nums["dp_score_deficit_pct"] == 0.0
    # the same read through a needless pair of gaps (1I 1D where a base
    # pairs with its own), its NM and ms as that path gives them
    bad = _line("r", 0, 101, "40M1I1D160M2I99M3D197M", _bytes(q), 0, 0)
    ops, lens = C.parse_cigar(bad[5])
    mis, ins, dele, ms, _ = C.walk(q, chrom, 100, ops, lens, SC)
    bad[11], bad[12] = f"NM:i:{mis + ins + dele}", f"ms:i:{ms}"
    nums, j = C.judge([bad], {"r": (_bytes(q), (0, 100, 600, False,
                                                True))},
                      ["chr1"], [chrom], SC, None, dp)
    assert nums["record_faults"] == 0
    assert nums["dp_score_deficit_pct"] > 0
