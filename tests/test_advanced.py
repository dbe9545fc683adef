"""ftab / bidirectional / MEM / kmer scalar engines, cross-validated
against brute-force text search (counts are over the fw+rc text, exactly
what the index stores)."""

import numpy as np
import pytest

from movi_tpu.build.prepare_ref import revcomp
from movi_tpu.build.suffix import build_bwt_runs
from movi_tpu.cpu_ref.advanced import AdvancedEngine, _is_empty
from movi_tpu.index.structure import build_move_index


def _overlap_count(hay: bytes, needle: bytes) -> int:
    n, i = 0, hay.find(needle)
    while i >= 0:
        n += 1
        i = hay.find(needle, i + 1)
    return n


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    fw = rng.choice(bases, size=3000).astype(np.uint8)
    text = np.concatenate([fw, revcomp(fw)])  # fw+rc as prepare_ref does
    ix = build_move_index(build_bwt_runs(text), "regular-thresholds")
    eng = AdvancedEngine(ix, ftab_k=4)
    hay = text.tobytes() + b"\x00"
    return text, ix, eng, hay


def test_ftab_entries_match_bruteforce(setup):
    text, ix, eng, hay = setup
    rng = np.random.default_rng(5)
    for code in rng.integers(0, 4 ** 4, size=40):
        kmer = eng.number_to_kmer(int(code), 4)
        iv = tuple(int(x) for x in eng.ftab[int(code)])
        cnt = 0 if _is_empty(iv) else eng.interval_count(*iv)
        assert cnt == _overlap_count(hay, kmer), kmer


def test_bidirectional_extension_counts(setup):
    text, ix, eng, hay = setup
    rng = np.random.default_rng(7)
    for _ in range(25):
        L = int(rng.integers(6, 25))
        s = int(rng.integers(0, len(text) - L))
        pat = text[s : s + L].tobytes()
        # backward init at the rightmost char, then extend_left over the rest
        bi, pos = eng.init_bidirectional(pat, L - 1)
        ok = True
        for j in range(pos - 1, -1, -1):
            if not eng.extend_left(pat[j], bi):
                ok = False
                break
        assert ok, pat
        assert eng.interval_count(*bi.fw) == _overlap_count(hay, pat)
        # rc interval counts the reverse complement occurrences
        rc_pat = bytes(reversed([{65: 84, 67: 71, 71: 67, 84: 65}[c]
                                 for c in pat]))
        assert eng.interval_count(*bi.rc) == _overlap_count(hay, rc_pat)


def test_extend_right_matches_bruteforce(setup):
    text, ix, eng, hay = setup
    rng = np.random.default_rng(9)
    for _ in range(15):
        L = int(rng.integers(8, 20))
        s = int(rng.integers(0, len(text) - L))
        pat = text[s : s + L].tobytes()
        bi, pos = eng.init_bidirectional(pat, 0)
        assert pos == 0
        for j in range(1, L):
            assert eng.extend_right(pat[j], bi), (pat, j)
        assert eng.interval_count(*bi.fw) == _overlap_count(hay, pat)


def _brute_mems(hay: bytes, read: bytes, min_len: int = 1):
    """All maximal exact matches of read vs hay with counts."""
    m = len(read)
    mems = []
    s = 0
    while s < m:
        # longest match starting at s
        e = s
        while e < m and _overlap_count(hay, read[s : e + 1]) > 0:
            e += 1
        if e > s:
            # maximal: cannot extend left (by construction of the scan)
            if e - s >= min_len:
                mems.append((s, e, _overlap_count(hay, read[s:e])))
            # next start: shortest shift where a longer right end may match
            s2 = s + 1
            while s2 < e and (e >= m or
                              _overlap_count(hay, read[s2 : e + 1]) == 0):
                s2 += 1
            s = s2 if s2 > s else s + 1
        else:
            s += 1
    # dedupe keeping only truly maximal ones (left-maximality)
    out = []
    for (s, e, c) in mems:
        contained = any(s2 <= s and e2 >= e and (s2, e2) != (s, e)
                        for (s2, e2, _) in mems)
        if not contained:
            out.append((s, e, c))
    return out


def test_all_mems_against_bruteforce(setup):
    text, ix, eng, hay = setup
    rng = np.random.default_rng(11)
    for t in range(10):
        # reads stitched from two reference pieces (guaranteed MEM break)
        L1, L2 = int(rng.integers(10, 30)), int(rng.integers(10, 30))
        s1 = int(rng.integers(0, len(text) - L1))
        s2 = int(rng.integers(0, len(text) - L2))
        read = text[s1 : s1 + L1].tobytes() + text[s2 : s2 + L2].tobytes()
        got = eng.query_all_mems(read)
        want = _brute_mems(hay, read)
        assert got == want, (t, got, want)


def test_mems_bml_min_length(setup):
    text, ix, eng, hay = setup
    rng = np.random.default_rng(13)
    for t in range(10):
        L1, L2 = int(rng.integers(12, 30)), int(rng.integers(12, 30))
        s1 = int(rng.integers(0, len(text) - L1))
        s2 = int(rng.integers(0, len(text) - L2))
        read = text[s1 : s1 + L1].tobytes() + text[s2 : s2 + L2].tobytes()
        min_len = 10
        got = eng.query_mems(read, min_mem_length=min_len)
        want = [m for m in _brute_mems(hay, read) if m[1] - m[0] >= min_len]
        assert got == want, (t, got, want)


def test_kmer_membership(setup):
    text, ix, eng, hay = setup
    rng = np.random.default_rng(17)
    k = 12
    for t in range(8):
        L = int(rng.integers(30, 80))
        s = int(rng.integers(0, len(text) - L))
        read = bytearray(text[s : s + L].tobytes())
        # sprinkle mismatches
        for _ in range(int(rng.integers(0, 4))):
            read[int(rng.integers(0, L))] = int(
                rng.choice(np.frombuffer(b"ACGT", np.uint8)))
        read = bytes(read)
        found_spans = eng.query_all_kmers(read, k)
        got_found = sum(cnt for _, cnt in found_spans)
        want_found = sum(
            1 for i in range(L - k + 1)
            if _overlap_count(hay, read[i : i + k]) > 0)
        assert got_found == want_found, (t, found_spans)


def test_kmer_counts_bidirectional(setup):
    text, ix, eng, hay = setup
    rng = np.random.default_rng(19)
    k = 10
    for t in range(5):
        L = int(rng.integers(25, 60))
        s = int(rng.integers(0, len(text) - L))
        read = text[s : s + L].tobytes()
        found, total = eng.count_kmers_bidirectional(read, k)
        want_found = sum(
            1 for i in range(L - k + 1)
            if _overlap_count(hay, read[i : i + k]) > 0)
        want_total = sum(
            _overlap_count(hay, read[i : i + k]) for i in range(L - k + 1))
        assert (found, total) == (want_found, want_total), t


def _walk_extend(eng, c, fw, rc):
    """The reference's bidirectional extension as written
    (move_structure_search.cpp:66-120): walk the interval's runs and the
    rc rows one at a time."""
    from movi_tpu.constants import complement_char

    ix = eng.ix
    c_comp = complement_char(c)
    new_fw = eng.backward_search_step(c, *fw)
    if _is_empty(new_fw):
        return False, fw, rc
    skip, (rs, os_, re, oe) = 0, fw
    run, off = rs, os_
    while run <= re:
        if run != ix.end_bwt_idx:
            if complement_char(int(ix.alphabet[ix.c_arr[run]])) < c_comp:
                skip += (int(ix.n_arr[run]) - off if run != re
                         else oe - off + 1)
        else:
            skip += 1
        run, off = run + 1, 0

    def advance(r_, o_, k):
        while k:
            after = int(ix.n_arr[r_]) - 1 - o_
            if after >= k:
                return r_, o_ + k
            r_, o_, k = r_ + 1, 0, k - after - 1
        return r_, o_

    rrs, ros = advance(rc[0], rc[1], skip)
    rre, roe = advance(rrs, ros, eng.interval_count(*new_fw) - 1)
    return True, new_fw, (rrs, ros, rre, roe)


@pytest.mark.parametrize("separators", [False, True])
def test_bidirectional_extension_matches_run_walk(tmp_path, separators):
    """The prefix-table extension (skip counts by lookup, rc moves by
    all_p) equals the reference's run-by-run walk on every state a MEM
    search visits, '$' and separator runs included."""
    from movi_tpu import synth
    from movi_tpu.build.prepare_ref import prepare_ref

    haps = synth.pangenome(seed=11, base_len=3000, haplotypes=3)
    fa = str(tmp_path / "p.fa")
    synth.write_fasta(fa, [(f"h{i}", h) for i, h in enumerate(haps)])
    ref = prepare_ref(fa, separators=separators)
    ix = build_move_index(build_bwt_runs(ref.text), "regular-thresholds",
                          separators=separators)
    eng = AdvancedEngine(ix)
    checked = 0
    for read in synth.sample_reads(haps, 40, 60, seed=12, err_rate=0.05):
        seq = read.tobytes()
        for pos in range(0, len(seq), 7):
            bi, _ = eng.init_bidirectional(seq, pos)
            for j in range(pos - 1, -1, -1):
                want = _walk_extend(eng, seq[j], bi.fw, bi.rc)
                assert eng.extend_bidirectional(seq[j], bi.fw,
                                                bi.rc) == want
                checked += 1
                if not want[0]:
                    break
                bi.fw, bi.rc = want[1], want[2]
    assert checked > 1000
