"""Device Movi Color engine: multi-class classification on the device.

The reference's multi-classify runs inside the prefetch query loop: per
base, after the LF step, the run's doc set votes for its documents and
best/second-best are tracked online (read_processor.cpp:122-186;
move_structure_query.cpp:373-470).

Device/host split of that work:

  device   the fused PML scan emits each base's color id alongside the
           matching length.  The color ids of both possible post-LF
           destinations are embedded in a widened 3-int32 record, so the
           whole color step stays ONE gather per base (a dependent
           doc_set_inds[new_idx] gather would serialize and cost ~2x; a
           fallback path does exactly that when >2^16-2 unique sets).
  host     a vectorized vote tally over the emitted matrices.  The online
           (best, second) tracking is order-dependent under ties; it is
           reconstructed exactly from two per-document aggregates:
             cnt[d]   final vote count
             last[d]  global step of d's final vote
                      (step = base * max_set_width + member position,
                       mirroring the sequential member loop over the
                       sorted doc set)
           best   = first doc to attain M  = argmin last among cnt == M
           second = first doc to attain M2 = argmin last among the rest
           (a doc's count only grows, so `last` IS the step it attained
           its final count; "first to attain the running maximum" is
           exactly the reference's `cnts[doc] > cnts[best]` update).

Bit-exact against the scalar ColorEngine across report-all /
min-diff-frac / min-score-frac / pvalue-scoring / min-match-len
(tests/test_fused_color.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .fused import (BIT_BUMP, BIT_DOLLAR_DN, BIT_DOLLAR_UP, BIT_USE_LF,
                    FA_MASK, FB_MASK, FB_SHIFT, FusedIndex,
                    build_fused_index, fused_pml_step, fused_step_math)
from ..color import (ColorTable, format_multiclass_cell)
from ..constants import UNCLASSIFIED_THRESHOLD
from ..index.structure import MoveIndex
from ..io.fastx import ReadBatch

LOG4 = math.log(4)


@dataclass
class FusedColorIndex:
    fi: FusedIndex
    doc_set_inds: jax.Array     # int32 [r] (color id per run; >= C if
                                # compressed away)
    num_colors: int             # C = number of kept unique sets
    # 3-word record (PML record + packed destination color id pair); None
    # when C+1 exceeds 16 bits (falls back to a second gather)
    records3: Optional[jax.Array] = None


jax.tree_util.register_dataclass(
    FusedColorIndex, data_fields=["fi", "doc_set_inds", "records3"],
    meta_fields=["num_colors"])


def build_fused_color_index(ix: MoveIndex, ct: ColorTable,
                            fi: Optional[FusedIndex] = None
                            ) -> FusedColorIndex:
    if fi is None:
        fi = build_fused_index(ix)
    C = len(ct.unique_doc_sets)
    cids = np.minimum(ct.doc_set_inds, C).astype(np.int64)
    records3 = None
    if C + 1 <= 0xFFFF:
        # widen the fused PML record with the color ids of the two
        # possible post-LF destinations of each slot -- (m, m+1) on the
        # LF path, (up, dn) on the reposition path -- packed in one extra
        # int32, so the whole color step stays ONE 12 B gather (a
        # dependent doc_set_inds[new_idx] gather would serialize ~2x)
        rec = np.asarray(fi.records).astype(np.int64)
        r, slots = ix.r, ix.sigma + 1
        rec = rec.reshape(r, slots, 2)
        w0, w1 = rec[:, :, 0], rec[:, :, 1]
        use_lf = (w1 >> BIT_USE_LF) & 1
        bump = (w1 >> BIT_BUMP) & 1
        d_up = (w1 >> BIT_DOLLAR_UP) & 1
        d_dn = (w1 >> BIT_DOLLAR_DN) & 1
        pd_run = fi.p_dollar[0]
        lo = np.where(use_lf == 1, w0, np.where(d_up == 1, pd_run, w0))
        hi = np.where(use_lf == 1, w0 + 1,
                      np.where(d_dn == 1, pd_run, w0 + bump))
        # unreachable candidates (no-ff guard, threshold-blocked side)
        # may be out of range; clip -- their cids are never selected
        wc = (cids[np.clip(lo, 0, r - 1)]
              | (cids[np.clip(hi, 0, r - 1)] << 16))
        rec3 = np.concatenate([rec, wc[:, :, None]], axis=2)
        records3 = jnp.asarray(
            rec3.reshape(r * slots, 3).astype(np.int32))
    return FusedColorIndex(
        fi=fi,
        doc_set_inds=jnp.asarray(cids.astype(np.int32)),
        records3=records3,
        num_colors=C)


def fused_color_step(records3, slots, p_dollar, state, a_eff):
    """One PML base step + the post-LF run's color id, from a single
    3-word record gather (fused_step_math plus the cid selector)."""
    idx, offset, ml = state
    rec = jnp.take(records3, idx * slots + a_eff, axis=0)  # [lanes, 3]
    new_state, new_ml = fused_step_math(rec, state, p_dollar)

    # destination selector: high half on LF fast-forward or reposition-down
    w1 = rec[:, 1]
    fa = w1 & FA_MASK
    fb = (w1 >> FB_SHIFT) & FB_MASK
    use_lf = (w1 >> BIT_USE_LF) & 1
    hi = jnp.where(use_lf == 1, fa + offset >= fb, offset >= fb)
    wc = rec[:, 2]
    cid = jnp.where(hi, (wc >> 16) & 0xFFFF, wc & 0xFFFF)
    return new_state, (new_ml, cid)


@jax.jit
def _fused_color_scan_carry(ci: FusedColorIndex, alphas_t: jax.Array,
                            state):
    """One chunk of the color scan with carried (idx, offset, ml) --
    the long-read path (see engine/fused.py _fused_pml_scan_carry)."""
    fi = ci.fi
    slots = fi.sigma + 1
    alphas_t = alphas_t.astype(jnp.int32)

    if ci.records3 is not None:
        def step(st, a):
            return fused_color_step(ci.records3, slots, fi.p_dollar, st, a)
    else:
        def step(st, a):
            new_state, ml = fused_pml_step(fi.records, slots, fi.p_dollar,
                                           st, a)
            cid = jnp.take(ci.doc_set_inds, new_state[0], axis=0)
            return new_state, (ml, cid)

    state, (ml, color) = jax.lax.scan(step, state, alphas_t)
    return state, ml, color


CHUNK = 2048


def _es_check(csum, stopped, ml, t, lens):
    """One step of the in-scan early-stop rule (the device mirror of
    _early_stop_len): emitted pml at global step t updates the running
    sum; at the reference's checkpoints the integer-exact mean test
    retires the lane."""
    csum = csum + ml
    p1 = lens - 2 - t
    chk = (p1 >= 0) & (2 * p1 < lens) & (p1 % 100 == 0)
    return csum, stopped | (chk & (5 * csum < 2 * (lens - p1)))


@jax.jit
def _fused_color_scan_carry_es(ci: FusedColorIndex, alphas_t: jax.Array,
                               t0: int, lens: jax.Array, state):
    """Early-stop variant of the carried color chunk: additionally
    carries (csum, stopped) per lane and returns all_retired, so the
    host chunk loop can stop issuing device work once every lane has
    either hit its stop point or run out of read
    (read_processor.cpp:240-250 as chunk-level lane retirement)."""
    fi = ci.fi
    slots = fi.sigma + 1
    alphas_t = alphas_t.astype(jnp.int32)
    core, csum, stopped = state
    n = alphas_t.shape[0]
    ts = t0 + jnp.arange(n, dtype=jnp.int32)

    if ci.records3 is not None:
        def pml_step(st, a):
            return fused_color_step(ci.records3, slots, fi.p_dollar, st, a)
    else:
        def pml_step(st, a):
            new_state, ml = fused_pml_step(fi.records, slots, fi.p_dollar,
                                           st, a)
            cid = jnp.take(ci.doc_set_inds, new_state[0], axis=0)
            return new_state, (ml, cid)

    def step(st, xs):
        core, csum, stopped = st
        a, t = xs
        core, (ml, cid) = pml_step(core, a)
        csum, stopped = _es_check(csum, stopped, ml, t, lens)
        return (core, csum, stopped), (ml, cid)

    (core, csum, stopped), (ml, color) = jax.lax.scan(
        step, (core, csum, stopped), (alphas_t, ts))
    retired = stopped | (t0 + n >= lens)
    return (core, csum, stopped), ml, color, jnp.all(retired)


def _fused_color_scan_es(ci: FusedColorIndex, alphas_t: jax.Array,
                         lens: jax.Array):
    """Chunked color scan with chunk-level lane retirement: identical
    (ml, color) content up to each lane's exact stop point, with rows
    past the last scanned chunk zero-filled (the host trim never reads
    them: every lane's stop point or read end lies within the scanned
    prefix).  Returns (ml, color, scanned_rows)."""
    fi = ci.fi
    W, lanes = alphas_t.shape
    core = (jnp.full((lanes,), fi.start_idx, dtype=jnp.int32),
            jnp.full((lanes,), fi.start_offset, dtype=jnp.int32),
            jnp.zeros((lanes,), dtype=jnp.int32))
    state = (core, jnp.zeros((lanes,), jnp.int32),
             jnp.zeros((lanes,), bool))
    pad = (-W) % CHUNK
    if pad:
        alphas_t = jnp.concatenate(
            [alphas_t, jnp.full((pad, lanes), fi.sigma, alphas_t.dtype)])
    mls, colors = [], []
    scanned = 0
    for c0 in range(0, W + pad, CHUNK):
        state, ml, color, all_ret = _fused_color_scan_carry_es(
            ci, jax.lax.slice_in_dim(alphas_t, c0, c0 + CHUNK), c0, lens,
            state)
        mls.append(ml)
        colors.append(color)
        scanned = min(c0 + CHUNK, W)
        if scanned < W and bool(np.asarray(all_ret)):
            break
    ml = jnp.concatenate(mls)[:W]
    color = jnp.concatenate(colors)[:W]
    if scanned < W:
        fill = W - ml.shape[0]
        ml = jnp.concatenate([ml, jnp.zeros((fill, lanes), ml.dtype)])
        color = jnp.concatenate(
            [color, jnp.zeros((fill, lanes), color.dtype)])
    return ml, color, scanned


def _fused_color_scan(ci: FusedColorIndex, alphas_t: jax.Array):
    """Returns (ml, color) both [W, lanes]; color = doc_set_inds of the
    post-LF run (clamped to C for compressed-away sets).  Long batches
    scan in fixed carried chunks (one compile regardless of W)."""
    fi = ci.fi
    W, lanes = alphas_t.shape
    state = (jnp.full((lanes,), fi.start_idx, dtype=jnp.int32),
             jnp.full((lanes,), fi.start_offset, dtype=jnp.int32),
             jnp.zeros((lanes,), dtype=jnp.int32))
    if W <= CHUNK:
        _, ml, color = _fused_color_scan_carry(ci, alphas_t, state)
        return ml, color
    pad = (-W) % CHUNK
    if pad:
        alphas_t = jnp.concatenate(
            [alphas_t, jnp.full((pad, lanes), fi.sigma, alphas_t.dtype)])
    mls, colors = [], []
    for c0 in range(0, W + pad, CHUNK):
        state, ml, color = _fused_color_scan_carry(
            ci, jax.lax.slice_in_dim(alphas_t, c0, c0 + CHUNK), state)
        mls.append(ml)
        colors.append(color)
    return jnp.concatenate(mls)[:W], jnp.concatenate(colors)[:W]


def _early_stop_len(pmls: np.ndarray, L: int) -> int:
    """Number of processed bases under the reference's early-stop rule:
    past the read midpoint, every 100 bases, abort when the running PML
    mean falls below the classification threshold
    (read_processor.cpp:240-250; scalar ColorEngine in color.py).
    Scan step t processes read position pos = L-1-t; the check uses
    p1 = pos - 1 and the PML sum through step t."""
    if L <= 0:
        return L
    csum = np.cumsum(pmls.astype(np.int64))
    t = np.arange(L)
    p1 = L - 2 - t
    chk = (p1 >= 0) & (2 * p1 < L) & (p1 % 100 == 0)
    # integer form of csum/(L-p1) < 0.4: exact, and identical to the
    # device retirement check (int32) and the scalar engine
    stop = chk & (5 * csum < 2 * (L - p1))
    hits = np.flatnonzero(stop)
    return int(hits[0]) + 1 if len(hits) else L


class FusedColorEngine:
    """Batched device multi-class classification."""

    def __init__(self, ci: FusedColorIndex, ct: ColorTable,
                 min_match_len: int = 0, pvalue_scoring: bool = False,
                 report_all: bool = False, min_diff_frac: float = 0.05,
                 min_score_frac: float = 0.0, early_stop: bool = False):
        self.ci = ci
        self.ct = ct
        self.min_match_len = min_match_len
        self.pvalue_scoring = pvalue_scoring
        self.report_all = report_all
        self.min_diff_frac = min_diff_frac
        self.min_score_frac = min_score_frac
        self.early_stop = early_stop
        self.last_scanned_rows = 0  # chunk-retirement observability
        di = ct.doc_info
        self.di = di
        C = len(ct.unique_doc_sets)
        self.C = C
        self.max_w = max((len(s) for s in ct.unique_doc_sets), default=1)
        # padded member table; row C = the compressed-away sentinel
        # (counts toward colors_count, votes for nothing)
        self.set_tab = np.full((C + 1, self.max_w), -1, dtype=np.int32)
        for i, s in enumerate(ct.unique_doc_sets):
            self.set_tab[i, : len(s)] = s
        self.log_lens = di.log_lens

    def query_batch_device(self, batch: ReadBatch):
        fi = self.ci.fi
        seqs_rev = batch.seqs[:, ::-1]
        alphas = fi.alphamap_query[seqs_rev]
        alphas_t = jnp.asarray(
            np.ascontiguousarray(alphas.T).astype(np.uint8))
        if self.early_stop and alphas_t.shape[0] > CHUNK:
            ml, color, scanned = _fused_color_scan_es(
                self.ci, alphas_t,
                jnp.asarray(batch.lengths.astype(np.int32)))
            self.last_scanned_rows = scanned
            return ml, color
        self.last_scanned_rows = alphas_t.shape[0]
        return _fused_color_scan(self.ci, alphas_t)

    def query_batch(self, batch: ReadBatch
                    ) -> List[Tuple[List[int], str, List[int]]]:
        """Per lane: (pmls, csv_cell, per-base color ids for
        --report-colors: kept color id when counted, C when skipped)."""
        ml_d, color_d = self.query_batch_device(batch)
        ml = np.asarray(ml_d)
        color = np.asarray(color_d)
        out = []
        for lane in range(batch.lanes):
            L = int(batch.lengths[lane])
            pmls = ml[:L, lane]
            cids = color[:L, lane]
            if self.early_stop:
                # lane retirement for unclassified reads (the reference
                # aborts the read loop, read_processor.cpp:240-250): the
                # stop point is a pure function of the emitted PML
                # stream, so the lockstep device scan runs unmasked and
                # the retirement truncates the emissions afterwards --
                # bit-equal to the scalar break, with the scan still one
                # fused gather per base
                n = _early_stop_len(pmls, L)
                pmls = pmls[:n]
                cids = cids[:n]
            cell, rep_colors = self._tally(pmls, cids, L)
            out.append((pmls.tolist(), cell, rep_colors))
        return out

    def _tally(self, pmls: np.ndarray, cids: np.ndarray, L: int
               ) -> Tuple[str, List[int]]:
        di = self.di
        S = di.num_species
        counted = pmls >= self.min_match_len
        colors_count = int(np.count_nonzero(counted))
        kept = counted & (cids < self.C)
        steps = np.flatnonzero(kept)
        # report-colors stream: kept color id per counted base, sentinel C
        # for skipped bases, nothing for compressed-away bases
        # (read_processor.cpp:128-186)
        rep_colors = [int(c) if k else self.C
                      for c, k, cn in zip(cids, kept, counted)
                      if k or not cn]
        members = self.set_tab[cids[steps]]           # [nv, max_w]
        valid = members >= 0
        docs = members[valid]
        # global step = base * max_w + member position (sequential member
        # loop order within the sorted set)
        base_steps = np.broadcast_to(
            (steps * self.max_w)[:, None], members.shape)
        pos_steps = base_steps + np.arange(self.max_w)[None, :]
        vote_steps = pos_steps[valid]

        cnt = np.zeros(S, dtype=np.int64)
        np.add.at(cnt, docs, 1)
        last = np.full(S, -1, dtype=np.int64)
        np.maximum.at(last, docs, vote_steps)
        if self.pvalue_scoring:
            mls_per_vote = np.broadcast_to(
                pmls[steps][:, None], members.shape)[valid]
            val = mls_per_vote - self.log_lens[docs] / LOG4
            w = np.where(val >= 0, np.minimum(val, 1.0), 0.0)
            score = np.zeros(S)
            np.add.at(score, docs, w)
            # scores only grow on val >= 0 votes; `last` must track the
            # final score-increasing vote
            last = np.full(S, -1, dtype=np.int64)
            np.maximum.at(last, docs[val >= 0], vote_steps[val >= 0])
            vals = score
            voted = score > 0
        else:
            vals = cnt
            voted = cnt > 0

        best = second = -1
        if voted.any():
            M = vals[voted].max()
            cand = np.flatnonzero(voted & (vals == M))
            best = int(cand[np.argmin(last[cand])])
            rest = voted.copy()
            rest[best] = False
            if rest.any():
                M2 = vals[rest].max()
                cand2 = np.flatnonzero(rest & (vals == M2))
                second = int(cand2[np.argmin(last[cand2])])

        pml_mean = float(pmls.sum()) / max(L, 1)
        cell = format_multiclass_cell(
            vals, best, second, colors_count, pml_mean, di,
            report_all=self.report_all, min_diff_frac=self.min_diff_frac,
            min_score_frac=self.min_score_frac)
        return cell, rep_colors
