"""ftab, bidirectional search, MEM finding, and k-mer queries (scalar).

Mirrors:
  - ftab build/lookup: move_structure_build.cpp:1121-1171,
    move_structure_search.cpp:203-293
  - bidirectional extension: move_structure_search.cpp:66-167
  - MEM finding: src/mem_finder.cpp
  - k-mer engine ("sequitur"): src/sequitur.cpp

The index must include reverse complements (prepare_ref default) for
bidirectional search (mem_finder.cpp:6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..constants import complement_char
from ..index.structure import MoveIndex
from .scalar import ScalarEngine

EMPTY = (1, 0, 0, 0)


@dataclass
class KmerStats:
    """Aggregated k-mer search statistics (include/sequitur.hpp:4-41)."""

    positive_kmers: int = 0
    positive_skipped: int = 0
    look_ahead_skipped: int = 0
    initialize_skipped: int = 0
    backward_search_failed: int = 0
    backward_search_empty: int = 0
    right_extension_failed: int = 0
    total_counts: int = 0

    def summary(self) -> str:
        return ("kmer statistics:\n"
                f"  positive kmers:        {self.positive_kmers}\n"
                f"  positive skipped:      {self.positive_skipped}\n"
                f"  look-ahead skipped:    {self.look_ahead_skipped}\n"
                f"  initialize skipped:    {self.initialize_skipped}\n"
                f"  backward search fails: {self.backward_search_failed}\n"
                f"  right extension fails: {self.right_extension_failed}\n"
                f"  total counts:          {self.total_counts}")


def _is_empty(iv):
    rs, os_, re, oe = iv
    return not (rs < re or (rs == re and os_ <= oe))


@dataclass
class BiInterval:
    fw: tuple
    rc: tuple
    match_len: int = 0


class AdvancedEngine(ScalarEngine):
    """ScalarEngine + ftab/bidirectional/MEM/kmer capabilities."""

    def __init__(self, index: MoveIndex, ftab_k: int = 0,
                 multi_ftab: bool = False):
        super().__init__(index)
        self.kmer_stats = KmerStats()
        self.ftab_k = ftab_k
        self.ftab: Optional[np.ndarray] = None
        self.multi_ftab = multi_ftab
        self.ftabs: dict = {}
        if ftab_k > 1:
            if multi_ftab:
                # --multi-ftab: build every even step down to 2
                # (movi.cpp:152-160, move_structure_search.cpp:265-272)
                for k in range(2, ftab_k + 1):
                    self.build_ftab(k)
                    self.ftabs[k] = self.ftab
                self.ftab = self.ftabs[ftab_k]
                self.ftab_k = ftab_k
            else:
                self.build_ftab(ftab_k)

    # ------------------------------------------------------------ ftab
    def kmer_to_number(self, seq: bytes, pos: int, k: int,
                       rc: bool = False) -> int:
        """utils.cpp:120-139."""
        ix = self.ix
        base = int(ix.alphamap[ord("A")])
        res = 0
        for i in range(k):
            c = seq[pos + i]
            if ix.alphamap[c] == 256:
                return -1
            if rc:
                code = int(ix.alphamap[complement_char(c)]) - base
                res |= code << (i * 2)
            else:
                code = int(ix.alphamap[c]) - base
                res |= code << ((k - i - 1) * 2)
        return res

    def number_to_kmer(self, j: int, k: int) -> bytes:
        ix = self.ix
        base = int(ix.alphamap[ord("A")])
        out = bytearray()
        for i in range(2 * k - 2, -1, -2):
            pair = (j >> i) & 0b11
            out.append(int(ix.alphabet[pair + base]))
        return bytes(out)

    def build_ftab(self, ftab_k: int):
        """move_structure_build.cpp:1121-1171: 4^k table of intervals."""
        self.ftab_k = ftab_k
        size = 4 ** ftab_k
        ftab = np.zeros((size, 4), dtype=np.int64)
        for i in range(size):
            kmer = self.number_to_kmer(i, ftab_k)
            iv = self.initialize_backward_search(kmer[-1])
            pos, iv = self._backward_search(kmer, ftab_k - 1, iv)
            if not _is_empty(iv) and pos == 0:
                ftab[i] = iv
            else:
                ftab[i] = EMPTY
        self.ftab = ftab

    def _backward_search(self, seq: bytes, pos: int, iv,
                         max_length: int = 1 << 30):
        """backward_search (move_structure_search.cpp:169-201): returns
        (pos, interval) -- final interval, or last non-empty one."""
        prev = iv
        pos_saved = pos
        while pos > 0 and not _is_empty(iv):
            prev = iv
            iv = self.backward_search_step(seq[pos - 1], *iv)
            if not _is_empty(iv):
                pos -= 1
            if pos_saved - pos > max_length:
                break
        if _is_empty(iv):
            return pos, prev
        return pos, iv

    def try_ftab(self, seq: bytes, pos_on_r: int, k: int, rc: bool = False):
        """move_structure_search.cpp:203-230.  Returns (interval or None,
        new_pos, match_len_delta)."""
        if self.ftab is None or k <= 1 or pos_on_r < k - 1:
            return None
        code = self.kmer_to_number(seq, pos_on_r - k + 1, k, rc=rc)
        if code < 0:
            return None
        iv = tuple(int(x) for x in self.ftab[code])
        if _is_empty(iv):
            return None
        return iv

    def init_search(self, seq: bytes, pos_on_r: int, rc: bool = False
                    ) -> Tuple[tuple, int, int]:
        """initialize_backward_search with optional (multi-)ftab
        (move_structure_search.cpp:261-293).
        Returns (interval, new_pos_on_r, match_len)."""
        if self.multi_ftab and self.ftab_k > 1:
            # fall back through smaller ftabs in steps of 2
            k = self.ftab_k
            while k > 1 and pos_on_r >= k - 1:
                saved = self.ftab, self.ftab_k
                self.ftab, self.ftab_k = self.ftabs.get(k), k
                iv = (self.try_ftab(seq, pos_on_r, k, rc=rc)
                      if self.ftab is not None else None)
                self.ftab, self.ftab_k = saved
                if iv is not None:
                    return iv, pos_on_r - k + 1, k - 1
                k -= 2
        elif self.ftab_k > 1:
            iv = self.try_ftab(seq, pos_on_r, self.ftab_k, rc=rc)
            if iv is not None:
                return iv, pos_on_r - self.ftab_k + 1, self.ftab_k - 1
        c = complement_char(seq[pos_on_r]) if rc else seq[pos_on_r]
        return self.initialize_backward_search(c), pos_on_r, 0

    # ---------------------------------------------------- bidirectional
    def _row_tables(self):
        """Per alphabet index a: rows[a][j] = rows held by runs < j with
        character a (the '$' run counts in none), plus each index's
        complement character.  Built once; turns the reference's walk
        over an interval's runs into two lookups per character."""
        if getattr(self, "_rows", None) is None:
            ix = self.ix
            if not np.array_equal(np.diff(ix.all_p), ix.n_arr):
                raise ValueError("all_p is not the prefix sum of n_arr")
            n = ix.n_arr.astype(np.int64)
            n[ix.end_bwt_idx] = 0
            rows = np.zeros((ix.sigma, ix.r + 1), np.int64)
            for a in range(ix.sigma):
                np.cumsum(np.where(ix.c_arr == a, n, 0), out=rows[a, 1:])
            comp = [complement_char(int(ch)) for ch in ix.alphabet]
            self._rows = (rows, comp)
        return self._rows

    def _advance(self, run: int, off: int, skip: int):
        """(run, offset) moved down by `skip` BWT rows."""
        all_p = self.ix.all_p
        pos = int(all_p[run]) + off + skip
        run = int(np.searchsorted(all_p, pos, side="right")) - 1
        return run, pos - int(all_p[run])

    def extend_bidirectional(self, c: int, fw, rc):
        """move_structure_search.cpp:66-120.  Returns (ok, fw', rc')."""
        ix = self.ix
        c_comp = complement_char(c)
        new_fw = self.backward_search_step(c, *fw)
        if _is_empty(new_fw):
            return False, fw, rc
        # count skipped rows: rows in fw whose complement(char) < c_comp
        # ('$' rows always count)
        rs, os_, re, oe = fw
        skip = 0
        if rs <= re:
            rows, comp = self._row_tables()
            e = ix.end_bwt_idx
            for a in range(ix.sigma):
                if comp[a] < c_comp:
                    skip += int(rows[a, re] - rows[a, rs])
                    if rs != e and ix.c_arr[rs] == a:
                        skip -= os_
                    if re != e and ix.c_arr[re] == a:
                        skip += oe + 1
            if rs <= e <= re:
                skip += 1
        # advance rc start by `skip` rows; rc end = rc start advanced by
        # count(fw')-1
        rrs, ros = self._advance(rc[0], rc[1], skip)
        rre, roe = self._advance(rrs, ros,
                                 self.interval_count(*new_fw) - 1)
        return True, new_fw, (rrs, ros, rre, roe)

    def extend_left(self, c: int, bi: BiInterval) -> bool:
        ok, fw, rc = self.extend_bidirectional(c, bi.fw, bi.rc)
        if ok:
            bi.fw, bi.rc = fw, rc
            bi.match_len += 1
        return ok

    def extend_right(self, c: int, bi: BiInterval) -> bool:
        ok, rc, fw = self.extend_bidirectional(complement_char(c), bi.rc,
                                               bi.fw)
        if ok:
            bi.rc, bi.fw = rc, fw
            bi.match_len += 1
        return ok

    def init_bidirectional(self, seq: bytes, pos_on_r: int
                           ) -> Tuple[BiInterval, int]:
        """initialize_bidirectional_search
        (move_structure_search.cpp:232-259)."""
        bi = BiInterval(fw=EMPTY, rc=EMPTY, match_len=0)
        pos_before = pos_on_r
        fw, pos_on_r, ml = self.init_search(seq, pos_on_r)
        bi.fw = fw
        if ml == 0 and self.ftab_k > 1:
            # ftab miss: signalled by match_len == 0 when ftab is in use
            bi.match_len = 0
            # still initialize rc for MEM usage
        ml += 1
        bi.match_len = ml
        pos_rc = pos_before
        rc, pos_rc, ml_rc = self.init_search(seq, pos_rc, rc=True)
        bi.rc = rc
        if ml - 1 != ml_rc:
            raise RuntimeError(
                "reverse complement not present in the reference")
        return bi, pos_on_r

    # ------------------------------------------------------------- MEMs
    def query_mems(self, seq: bytes, min_mem_length: int = 0
                   ) -> List[Tuple[int, int, int]]:
        """mem_finder.cpp:7-25; returns [(start, end_exclusive, count)]."""
        if min_mem_length <= 1:
            return self.query_all_mems(seq)
        mems: List[Tuple[int, int, int]] = []
        pos = 0
        while pos < len(seq):
            pos = self._query_mem_bml(seq, pos, min_mem_length, mems)
        return mems

    def _query_mem_bml(self, seq: bytes, pos_on_r: int, L: int,
                       mems: list) -> int:
        """mem_finder.cpp:29-103 (BML: backward-extend the length-L window,
        then forward-extend to maximality)."""
        m = len(seq)
        if pos_on_r + L > m:
            return m
        init_pos = pos_on_r + L - 1
        bi, init_pos2 = self.init_bidirectional(seq, init_pos)
        ftab_skip = bi.match_len <= 1 and self.ftab_k <= L
        init_pos = init_pos2 - 1

        if ftab_skip and self.ftab_k > 1:
            # ftab miss: the window k-mer is absent; backward-only scan to
            # find the next candidate left end (mem_finder.cpp:44-56)
            fw = bi.fw
            for j in range(init_pos - pos_on_r + 1):
                fw2 = self.backward_search_step(seq[init_pos - j], *fw)
                if _is_empty(fw2):
                    return init_pos - j + 1
                fw = fw2
            raise RuntimeError("extended past failed ftab")

        for j in range(init_pos - pos_on_r + 1):
            if not self.extend_left(seq[init_pos - j], bi):
                return init_pos - j + 1

        # forward extension to maximality
        rc = bi.rc
        rc_before = rc
        i = pos_on_r + L
        while i < m:
            rc_before = rc
            rc2 = self.backward_search_step(complement_char(seq[i]), *rc)
            if _is_empty(rc2):
                rc = rc_before
                break
            rc = rc2
            i += 1
        mems.append((pos_on_r, i, self.interval_count(*rc)))

        # find next candidate left end (mem_finder.cpp:83-101)
        end_pos = i
        j_steps = 0
        init_pos = pos_on_r  # fallback
        if end_pos < m:
            init_pos = end_pos
            fw, init_pos, ml = self.init_search(seq, init_pos)
            init_pos -= 1
            i2 = 0
            while i2 <= init_pos - (pos_on_r + 1):
                fw2 = self.backward_search_step(seq[init_pos - i2], *fw)
                if _is_empty(fw2):
                    break
                fw = fw2
                i2 += 1
            return init_pos - i2 + 1
        return m

    def query_all_mems(self, seq: bytes) -> List[Tuple[int, int, int]]:
        """mem_finder.cpp:105-145 (min length <= 1).

        The loop invariant: `bi` matches seq[s .. s+match_len-1]; the
        initializations consume one char (or ftab_k chars), tracked by
        bi.match_len exactly as the by-reference match_len in the C++.
        """
        m = len(seq)
        mems: List[Tuple[int, int, int]] = []
        s = 0
        bi, _ = self.init_bidirectional(seq, s)
        match_len = bi.match_len
        while s < m:
            bi_before = BiInterval(bi.fw, bi.rc, bi.match_len)
            while s + match_len < m and self.extend_right(
                    seq[s + match_len], bi):
                bi_before = BiInterval(bi.fw, bi.rc, bi.match_len)
                match_len += 1
            e = s + match_len
            mems.append((s, e, self.interval_count(*bi_before.fw)))
            match_len = 0
            if e < m:
                bi, _ = self.init_bidirectional(seq, e)
                match_len = bi.match_len
                bi_before = BiInterval(bi.fw, bi.rc, bi.match_len)
                while e - match_len >= 0 and self.extend_left(
                        seq[e - match_len], bi):
                    bi_before = BiInterval(bi.fw, bi.rc, bi.match_len)
                    match_len += 1
                bi = bi_before
                match_len = bi.match_len
            s = e - match_len + 1
        return mems

    # ------------------------------------------------------------ kmers
    def query_all_kmers(self, seq: bytes, k: int
                        ) -> List[Tuple[int, int]]:
        """Membership mode of query_all_kmers (sequitur.cpp:322-421):
        returns [(kmer_start_pos, found_run_count)], where found_run_count
        kmers ending at consecutive positions were found."""
        m = len(seq)
        out: List[Tuple[int, int]] = []
        pos = m - 1
        if k == 1:
            found = sum(1 for c in seq if self.check_alphabet(c))
            return [(0, found)]
        while pos >= 0 and not self.check_alphabet(seq[pos]):
            pos -= 1
        step = k // 3
        if k - step < self.ftab_k:
            step = k - self.ftab_k - 1
        while pos >= k - 1:
            if pos >= k - 1 + step and not self._look_ahead(seq, pos, step, k):
                self.kmer_stats.look_ahead_skipped += step + 1
                pos = pos - step - 1
            else:
                pos, found = self._query_kmers_from(seq, pos, k)
                self.kmer_stats.positive_kmers += found
                if found > 0:
                    self.kmer_stats.positive_skipped += found - 1
                    out.append((pos + 2 - k, found))
                else:
                    self.kmer_stats.backward_search_failed += 1
            while pos >= 0 and not self.check_alphabet(seq[pos]):
                pos -= 1
        return out

    def _look_ahead(self, seq: bytes, pos_on_r: int, step: int, k: int
                    ) -> bool:
        """look_ahead_backward_search (move_structure_search.cpp:371-385)."""
        pos_ahead = pos_on_r - step
        iv, pos_ahead, ml = self.init_search(seq, pos_ahead)
        pos_ahead, _ = self._backward_search(seq, pos_ahead, iv,
                                             max_length=k - step - ml)
        return pos_on_r - pos_ahead >= k - 1

    def _query_kmers_from(self, seq: bytes, pos_on_r: int, k: int
                          ) -> Tuple[int, int]:
        """query_kmers_from (sequitur.cpp:257-320).  Returns
        (new_pos_on_r, kmers_found); note pos_on_r after a successful run
        points at the next unchecked kmer end + k - 2 semantics."""
        pos_saved = pos_on_r
        ml = 0
        while True:
            iv, pos_on_r, ml = self.init_search(seq, pos_on_r)
            if ml == 0 and self.ftab_k > 1:
                pos_on_r -= 1
                pos_saved = pos_on_r
                if not (pos_on_r >= k - 1):
                    break
                continue
            break
        if pos_on_r < 0:
            return pos_on_r, 0
        pos_on_r, iv = self._backward_search(seq, pos_on_r, iv)
        if _is_empty(iv):
            return pos_saved - 1, 0
        if pos_saved - pos_on_r >= k - 1:
            found = pos_saved - pos_on_r - k + 2
            return pos_on_r + k - 2, found
        return pos_saved - 1, 0

    def count_kmers_bidirectional(self, seq: bytes, k: int) -> Tuple[int, int]:
        """Exact count mode: returns (found_kmers, total_counts), using
        query_kmers_from_bidirectional (sequitur.cpp:14-255) semantics via
        a straightforward per-kmer backward search fallback (counts are
        identical; the bidirectional caching is a CPU optimization that
        the batched device engine replaces with lane parallelism)."""
        m = len(seq)
        found = 0
        total = 0
        for end in range(m - 1, k - 2, -1):
            start = end - k + 1
            kmer = seq[start : end + 1]
            if not all(self.check_alphabet(c) for c in kmer):
                continue
            iv = self.initialize_backward_search(kmer[-1])
            pos, iv = self._backward_search(kmer, k - 1, iv)
            if pos == 0 and not _is_empty(iv):
                found += 1
                total += self.interval_count(*iv)
        self.kmer_stats.positive_kmers += found
        self.kmer_stats.total_counts += total
        return found, total
