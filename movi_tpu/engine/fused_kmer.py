"""Device k-mer membership engine.

Vectorizes query_all_kmers / query_kmers_from (sequitur.cpp:257-421) as a
lockstep per-lane state machine over the fused search records:

  each lane carries (anchor pos, cursor, interval, phase); one tick is
  either a backward-search extension (fused_bs_step) or a cheap re-anchor.
  A finished match stretch [cur, pos] emits found = pos - cur - k + 2
  kmers at start position cur (exactly the reference's
  add_kmer(pos_on_r + 2 - k, found)), then re-anchors at cur + k - 2.

The reference's look-ahead probe (step = k/3 ahead; skip step+1
positions on failure) IS implemented, as a probe phase of the same
tick machine: it is a work optimization that lane parallelism does not
replace, worth ~4-6x on NOT_FOUND-heavy reads (the contamination-
screening workload).  Emissions are unchanged -- skipped regions emit
nothing either way.  The ftab initialization remains a CPU-only
optimization (a device init would not reduce gathered rows per tick).
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .fused_search import (_CHAR_ONEHOT_MAX_W, FusedSearchIndex,
                           _char_select, _emit_add, _init_interval,
                           _init_interval_oh, _lf_from_rec,
                           fused_bs_step)
from ..io.fastx import ReadBatch


def make_kmer_state(lanes: int, W: int, lengths: jax.Array, k: int):
    pos_init = lengths.astype(jnp.int32) - 1
    # phase: 0 = need anchor, 1 = extending, 2 = done, 3 = probing
    z = jnp.zeros((lanes,), jnp.int32)
    return dict(
        phase=jnp.where(pos_init >= k - 1, 0, 2),
        pos=pos_init,
        cur=z, pc=z, pok=z, pinit=z,
        rs=z, os=z, re=z, oe=z,
        out=jnp.zeros((lanes, W), jnp.int32),
    )


@partial(jax.jit, static_argnums=(3, 4, 5))
def _kmer_scan(si: FusedSearchIndex, alc: jax.Array, state, k: int,
               ticks: int, use_ftab: bool = False):
    """alc: int32 [lanes, W] read-order slots (-1 illegal); with
    use_ftab, [lanes, 2W] -- slots next to per-position fk-mer codes
    (fused_mem2._prep_alc).  Resumable: returns (state', all_done).

    Look-ahead skipping (sequitur.cpp:322-421; look_ahead_backward_search
    move_structure_search.cpp:354-385): before anchoring a full stretch
    at pos, probe a backward stretch from pos - step (step = k/3); if it
    cannot cover k-1 positions, no k-mer ending in (pos-step-1, pos]
    exists and the machine skips step+1 positions.  On NOT_FOUND-heavy
    reads (contamination screening) this skips most of the work.

    ftab anchors: with use_ftab, stretch anchors and probe inits gather
    the position's fk-mer interval from the rows appended to rec_all --
    the SAME per-tick gather -- jumping fk chars on a hit; an absent
    fk-mer advances the anchor by one (identical emissions: the
    ftab-less stretch would die inside the fk span and do the same) or
    fails the probe instantly (valid because fk <= k - step, so a probe
    whose fk-suffix is absent can never cover k-1 positions).
    Emissions are unchanged in every case.
    """
    r, sigma = si.r, si.sigma
    FTB = 2 * sigma * r
    fk = si.ftab_k
    lanes = alc.shape[0]
    W = alc.shape[1] // 2 if use_ftab else alc.shape[1]
    alphas = alc[:, :W]
    lane_iota = jnp.arange(lanes)
    step = k // 3
    max_len = k - step  # probe length budget (ml = 0 without ftab)

    def select_at(pos):
        # ONE phase-selected [lanes, W] one-hot per tick (chars and,
        # under ftab, codes share the same mask)
        p = jnp.clip(pos, 0, W - 1)
        if W <= _CHAR_ONEHOT_MAX_W:
            oh = p[:, None] == jnp.arange(W, dtype=p.dtype)[None, :]
            c = jnp.sum(jnp.where(oh, alphas, 0), axis=1)
            if use_ftab:
                return c, jnp.sum(jnp.where(oh, alc[:, W:], 0), axis=1)
            return c, None
        c = alphas[lane_iota, p]
        if use_ftab:
            return c, alc[:, W:][lane_iota, p]
        return c, None

    def tick(state, _):
        phase = state["phase"]
        pos = state["pos"]
        cur = state["cur"]
        pc = state["pc"]
        pok = state["pok"]
        pinit = state["pinit"]

        in_anchor = phase == 0
        extending = phase == 1
        probing = phase == 3
        pi = probing & (pinit == 1)

        # anchor char at pos, probe-init char at pc, probe step at
        # pc-1, stretch step at cur-1
        p_sel = jnp.where(in_anchor, pos,
                          jnp.where(probing,
                                    jnp.where(pi, pc, pc - 1), cur - 1))
        c_sel, code_sel = select_at(p_sel)

        # ---- anchoring lanes (phase 0): decide; init via the gather
        anchor_illegal = in_anchor & (c_sel < 0)
        pos1 = jnp.where(anchor_illegal, pos - 1, pos)
        legal = in_anchor & (c_sel >= 0) & (pos1 >= k - 1)
        eligible = (legal & (pos1 >= k - 1 + step) & (pok == 0)) \
            if step >= 1 else jnp.zeros_like(legal)
        anchored = legal & ~eligible
        pc1 = jnp.where(eligible, pos1 - step, pc)
        pinit1 = jnp.where(eligible, 1, pinit)
        phase1 = jnp.where(eligible, 3, jnp.where(anchored, 1, phase))
        pok1 = jnp.where(anchored, 0, pok)
        cur1 = jnp.where(anchored, pos1, cur)
        phase1 = jnp.where((phase1 == 0) & (pos1 < k - 1), 2, phase1)

        # ---- the ONE gather: step records, or ftab anchor rows ----
        rs, os_, re, oe = (state["rs"], state["os"], state["re"],
                           state["oe"])
        can_step = extending & (cur1 > 0)
        can_pstep = probing & ~pi & (pc1 > 0)
        a_gate = jnp.where(can_step | can_pstep, c_sel, -1)
        a_s = jnp.maximum(a_gate, 0)
        key_lo = a_s * r + jnp.minimum(jnp.maximum(rs, 0), r - 1)
        key_hi = (sigma * r + a_s * r
                  + jnp.minimum(jnp.maximum(re, 0), r - 1))
        if use_ftab:
            code_ok = code_sel >= 0
            ftl = (anchored | pi) & code_ok
            fkey = FTB + jnp.maximum(code_sel, 0)
            key_lo = jnp.where(ftl, fkey, key_lo)
            key_hi = jnp.where(ftl, fkey, key_hi)
        both = jnp.take(si.rec_all,
                        jnp.concatenate([key_lo, key_hi]), axis=0)
        rd, ru = both[:lanes], both[lanes:]
        drs = rd[:, 0]
        dre = ru[:, 0]
        empty = (a_gate < 0) | (drs >= r) | (drs > re)
        os1 = jnp.where(drs != rs, 0, os_)
        oe1 = jnp.where(dre != re, ru[:, 3] - 1, oe)
        nrs, nos = _lf_from_rec(rd, os1)
        nre, noe = _lf_from_rec(ru, oe1)

        # ---- interval init: ftab row, or single-char one-hot ----
        irs, ios, ire, ioe = _init_interval_oh(si, c_sel)
        if use_ftab:
            f_empty = ~((rd[:, 0] < rd[:, 2])
                        | ((rd[:, 0] == rd[:, 2])
                           & (rd[:, 1] <= rd[:, 3])))
            a_hit = anchored & code_ok & ~f_empty
            a_miss = anchored & code_ok & f_empty
            a_plain = anchored & ~code_ok
            p_hit = pi & code_ok & ~f_empty
            p_missf = pi & code_ok & f_empty       # probe fails instantly
            p_plain = pi & ~code_ok & (c_sel >= 0)
            do_row = a_hit | p_hit
            do_plain = a_plain | p_plain
            rs = jnp.where(do_row, rd[:, 0], jnp.where(do_plain, irs, rs))
            os_ = jnp.where(do_row, rd[:, 1],
                            jnp.where(do_plain, ios, os_))
            re = jnp.where(do_row, rd[:, 2], jnp.where(do_plain, ire, re))
            oe = jnp.where(do_row, rd[:, 3],
                           jnp.where(do_plain, ioe, oe))
            # stretch ftab hit jumps the cursor; a miss advances the
            # anchor by one (the ftab-less stretch would die inside the
            # span and re-anchor identically)
            cur1 = jnp.where(a_hit, pos1 - fk + 1, cur1)
            pos1 = jnp.where(a_miss, pos1 - 1, pos1)
            phase1 = jnp.where(a_miss,
                               jnp.where(pos1 >= k - 1, 0, 2), phase1)
            pc1 = jnp.where(p_hit, pc1 - (fk - 1), pc1)
            pinit1 = jnp.where(p_hit | p_plain, 0, pinit1)
            pi_fail = (pi & (c_sel < 0)) | p_missf
        else:
            do_init = anchored | (pi & (c_sel >= 0))
            rs = jnp.where(do_init, irs, rs)
            os_ = jnp.where(do_init, ios, os_)
            re = jnp.where(do_init, ire, re)
            oe = jnp.where(do_init, ioe, oe)
            pinit1 = jnp.where(pi & (c_sel >= 0), 0, pinit1)
            pi_fail = pi & (c_sel < 0)

        # ---- commit the shared step ----
        step_ok = can_step & ~empty
        pstep_ok = can_pstep & ~empty
        moved = step_ok | pstep_ok
        rs = jnp.where(moved, nrs, rs)
        os_ = jnp.where(moved, nos, os_)
        re = jnp.where(moved, nre, re)
        oe = jnp.where(moved, noe, oe)
        cur2 = jnp.where(step_ok, cur1 - 1, cur1)
        pc2 = jnp.where(pstep_ok, pc1 - 1, pc1)

        # ---- probe termination (mirrors _backward_search's loop) ----
        plen = (pos1 - step) - pc2
        probe_end = (probing & ~pi
                     & (~can_pstep | (can_pstep & empty)
                        | (pstep_ok & (plen > max_len)))) | pi_fail
        passed = pos1 - pc2 >= k - 1
        pok2 = jnp.where(probe_end & passed, 1, pok1)
        pos2 = jnp.where(probe_end & ~passed, pos1 - step - 1, pos1)
        phase2 = jnp.where(probe_end, 0, phase1)
        phase2 = jnp.where(probe_end & ~passed & (pos2 < k - 1), 2,
                           phase2)

        # ---- stretch terminated: failed step, or reached position 0
        terminated = extending & (~step_ok)
        matched = pos1 - cur2  # pos_saved - pos_on_r in the reference
        found = matched - k + 2
        emit = terminated & (matched >= k - 1)
        out = _emit_add(state["out"], lane_iota, cur2,
                        jnp.where(emit, found, 0))
        # new anchor: cur + k - 2 on success, pos - 1 otherwise
        new_pos = jnp.where(emit, cur2 + k - 2, pos1 - 1)
        pos2 = jnp.where(terminated, new_pos, pos2)
        phase2 = jnp.where(terminated,
                           jnp.where(new_pos >= k - 1, 0, 2), phase2)

        new_state = dict(phase=phase2, pos=pos2, cur=cur2, pc=pc2,
                         pok=pok2, pinit=pinit1, rs=rs, os=os_, re=re,
                         oe=oe, out=out)
        return new_state, None

    state, _ = jax.lax.scan(tick, state, None, length=ticks)
    return state, jnp.all(state["phase"] == 2)


@partial(jax.jit, static_argnums=(2,))
def _kmer_count_scan(si: FusedSearchIndex, alphas: jax.Array, k: int):
    """Exact-count kernel: one lane per k-mer.  alphas: int32 [k, nk] in
    k-mer order (row 0 = first char); every lane runs exactly k-1
    backward-search extensions in lockstep -- the uniform device replacement
    for the reference's bidirectional partial-interval caching
    (query_kmers_from_bidirectional, sequitur.cpp:14-255), which is a CPU
    work-saving device; counts are identical.  Returns (found, count)."""
    legal = jnp.all(alphas >= 0, axis=0)
    rs, os_, re, oe = _init_interval(si, alphas[k - 1])
    state = dict(rs=rs, os=os_, re=re, oe=oe, dead=~legal)

    def body(state, a):
        nrs, nos, nre, noe, empty = fused_bs_step(
            si, state["rs"], state["os"], state["re"], state["oe"], a)
        ok = ~state["dead"] & ~empty
        return dict(
            rs=jnp.where(ok, nrs, state["rs"]),
            os=jnp.where(ok, nos, state["os"]),
            re=jnp.where(ok, nre, state["re"]),
            oe=jnp.where(ok, noe, state["oe"]),
            dead=state["dead"] | empty,
        ), None

    # extend with kmer[k-2] ... kmer[0]
    state, _ = jax.lax.scan(body, state, alphas[:-1][::-1])
    found = ~state["dead"] & legal
    cnt = (jnp.take(si.all_p, state["re"], axis=0) + state["oe"]
           - jnp.take(si.all_p, state["rs"], axis=0) - state["os"] + 1)
    return found, jnp.where(found, cnt, 0)



def batch_kmer_windows(batch: ReadBatch, amap, k: int):
    """Vectorized ([k, nk] window slot columns, [nk] owner lanes) for
    every k-mer window of every read: one left_aligned_slots gather +
    one sliding_window_view instead of a per-lane Python loop (seconds
    per 32k-lane batch)."""
    from ..io.fastx import left_aligned_slots

    al = left_aligned_slots(batch, amap, fill=-1)       # [lanes, W]
    W = batch.width
    if W < k:
        return None, None
    w = np.lib.stride_tricks.sliding_window_view(al, k, axis=1)
    starts = np.arange(W - k + 1, dtype=np.int64)[None, :]
    valid = starts + k <= batch.lengths.astype(np.int64)[:, None]
    own, pos = np.nonzero(valid)
    if len(own) == 0:
        return None, None
    return np.ascontiguousarray(w[own, pos].T).astype(np.int32), own


class FusedKmerCountEngine:
    """Exact k-mer counts, one device lane per k-mer.  Results identical
    to AdvancedEngine.count_kmers_bidirectional."""

    def __init__(self, si: FusedSearchIndex, k: int):
        self.si = si
        self.k = k

    def query_batch(self, batch: ReadBatch) -> List[Tuple[int, int]]:
        """Per read: (found_kmers, total_counts)."""
        k = self.k
        al, own = batch_kmer_windows(batch, self.si.alphamap_query, k)
        if al is None:
            return [(0, 0)] * batch.lanes
        found, cnt = _kmer_count_scan(self.si, jnp.asarray(al), k)
        found = np.asarray(found)
        cnt = np.asarray(cnt)
        f = np.zeros(batch.lanes, dtype=np.int64)
        t = np.zeros(batch.lanes, dtype=np.int64)
        np.add.at(f, own, found.astype(np.int64))
        np.add.at(t, own, cnt.astype(np.int64))
        return [(int(f[i]), int(t[i])) for i in range(batch.lanes)]


class FusedKmerEngine:
    def __init__(self, si: FusedSearchIndex, k: int):
        self.si = si
        self.k = k

    def query_batch(self, batch: ReadBatch) -> List[List[Tuple[int, int]]]:
        """Per read: [(kmer_start_pos, found_count)] in descending
        position order, identical to AdvancedEngine.query_all_kmers."""
        # LEFT-align reads in read order for per-lane position indexing
        W = batch.width
        lanes = batch.lanes
        from ..io.fastx import left_aligned_slots

        ticks = 2 * W + 64
        # ship int8 (a quarter of the upload), widen once on device;
        # ftab anchors apply when the index carries the rows and the
        # instant-probe-fail bound fk <= k - step holds
        fk = self.si.ftab_k
        use_ftab = 1 < fk <= self.k - self.k // 3
        from .fused_mem2 import _prep_alc

        al = _prep_alc(
            jnp.asarray(left_aligned_slots(
                batch, self.si.alphamap_query, fill=-1).astype(np.int8)),
            fk if use_ftab else 0, use_ftab)
        state = make_kmer_state(lanes, W,
                                jnp.asarray(batch.lengths.astype(np.int32)),
                                self.k)
        # worst case is O(W*k) ticks (same as the scalar re-scan
        # overlap); resume until every lane is done, with retired lanes
        # compacted out between quanta (fused_mem._resume_compacted)
        from .fused_mem import _resume_compacted

        (out_all,) = _resume_compacted(
            lambda a, st: _kmer_scan(self.si, a, st, self.k, ticks,
                                     use_ftab),
            state, al, lanes, W, done_phase=2,
            max_iters=2 * self.k + 8, emit_keys=("out",), label="kmer")
        res = []
        for i in range(lanes):
            nz = np.flatnonzero(out_all[i])
            res.append([(int(p), int(out_all[i][p])) for p in nz[::-1]])
        return res
