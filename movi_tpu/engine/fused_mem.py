"""Device MEM finder (BML algorithm, mem_finder.cpp:29-103).

Vectorizes AdvancedEngine.query_mems (min_mem_length >= 2, no ftab) as a
lockstep per-lane state machine, like the k-mer engine:

  INIT  anchor a length-L window at pos; bidirectional init on its last
        char (initialize_bidirectional_search,
        move_structure_search.cpp:232-259)
  BACK  extend_left over the remaining L-1 window chars; a failure at
        step j re-anchors at pos+L-1-j
  FWD   forward-extend to maximality: plain backward steps of the
        complemented read char on the rc interval
  NEXT  after emitting (start, end, count), backward-scan from the MEM
        end to the next candidate left end (mem_finder.cpp:83-101)

Every tick performs exactly one fused backward-search step (2 record
gathers) on a phase-selected (interval, char).  The extend_bidirectional
"skip" count (move_structure_search.cpp:66-120) -- rows of the fw
interval whose complemented character precedes the threshold char, walked
run-by-run on the CPU -- collapses into two gathers of a precomputed
per-(threshold, run) prefix table, and the rc-interval reposition becomes
a device searchsorted into all_p.

Bit-exact against AdvancedEngine.query_mems with ftab_k=0
(tests/test_fused_mem.py).  The reference's ftab initialization only
accelerates scanning; it does not change the emitted MEMs.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .fused_search import (FusedSearchIndex, _char_select,
                           _emit_add, _init_interval_oh,
                           build_fused_search_index, fused_bs_step)
from ..index.structure import MoveIndex
from ..io.fastx import ReadBatch

# phases
INIT, BACK, FWD, NEXT, DONE = 0, 1, 2, 3, 4


@dataclass
class FusedMemIndex:
    si: FusedSearchIndex
    # skip_rec[t*r + run] = (P, u): P = weighted rows before the run,
    # u = per-row weight (comp(char(run)) < t, or the '$' run)
    skip_rec: jax.Array   # int32 [sigma*r, 2]
    all_p64: jax.Array    # int32 [r+1] for searchsorted reposition
    # pos2rba[abs] = (run containing BWT row abs, all_p[run]): turns
    # the per-tick rc-interval reposition from a ~log2(r)-round
    # dependent-gather binary search (jnp.searchsorted) into ONE
    # gathered 8 B row.  8 B per BWT position; built when
    # n <= POS2RUN_MAX_N, else None (the searchsorted fallback).
    pos2rba: jax.Array | None = None


jax.tree_util.register_dataclass(
    FusedMemIndex, data_fields=["si", "skip_rec", "all_p64", "pos2rba"],
    meta_fields=[])

POS2RUN_MAX_N = 1 << 27   # 1 GB of pos2rba; past this, searchsorted


@partial(jax.jit, static_argnames=("r", "n"))
def _pos2rba_device(n_arr, all_p, r: int, n: int):
    """Build pos2rba ON DEVICE from the tiny (n_arr, all_p) inputs: the
    table is 8 B per BWT position (1 GB at the cap), which would cost
    ~40 s on the ~25 MB/s host->device link if shipped; the device
    cumsum/repeat build uploads only 2 * 4 B/run instead."""
    runs = jnp.repeat(jnp.arange(r, dtype=jnp.int32), n_arr,
                      total_repeat_length=n)
    return jnp.stack([runs, jnp.take(all_p, runs, axis=0)], axis=1)


def build_fused_mem_index(ix: MoveIndex) -> FusedMemIndex:
    si = build_fused_search_index(ix)
    r, sigma = ix.r, ix.sigma
    assert bytes(ix.alphabet) == b"ACGT", (
        "device MEM engine requires the ACGT alphabet (complement is "
        "index-reversal)")
    assert int(ix.n_arr[ix.end_bwt_idx]) == 1, (
        "the '$' run must be a single row")
    # shared skip-table construction (the '$'-row weighing rule is
    # load-bearing for bit-exactness; one copy only)
    from ..cpu_ref.native_search import build_skip_tables

    P_tab, U_tab = build_skip_tables(ix)
    skip = np.stack([P_tab, U_tab.astype(np.int64)], axis=2)
    n = int(ix.all_p[-1])
    pos2rba = None
    if n <= POS2RUN_MAX_N:
        pos2rba = _pos2rba_device(
            jnp.asarray(ix.n_arr.astype(np.int32)), si.all_p[:-1],
            r=r, n=n)
    return FusedMemIndex(
        si=si,
        skip_rec=jnp.asarray(skip.reshape(sigma * r, 2).astype(np.int32)),
        all_p64=si.all_p, pos2rba=pos2rba)


def _resolve(all_p, abs_pos):
    """(run, offset) of an absolute BWT row (the unbounded fast_forward
    as a fixed-depth searchsorted, SURVEY.md 'hard parts')."""
    run = jnp.searchsorted(all_p, abs_pos, side="right").astype(jnp.int32) - 1
    return run, abs_pos - jnp.take(all_p, run, axis=0)


def _resolve_mi(mi: "FusedMemIndex", abs_pos):
    """Tick-machine reposition: ONE gathered (run, all_p[run]) row when
    the direct table exists (inactive lanes carry garbage positions --
    clip for the gather; their results are never selected), else the
    searchsorted fallback."""
    if mi.pos2rba is not None:
        n = mi.pos2rba.shape[0]
        row = jnp.take(mi.pos2rba, jnp.clip(abs_pos, 0, n - 1), axis=0)
        return row[:, 0], abs_pos - row[:, 1]
    return _resolve(mi.si.all_p, abs_pos)


def _count(all_p, rs, os_, re, oe):
    return (jnp.take(all_p, re, axis=0) + oe
            - jnp.take(all_p, rs, axis=0) - os_ + 1)


def make_mem_state(lanes: int, W: int, lengths: jax.Array, L: int):
    z = jnp.zeros((lanes,), jnp.int32)
    return dict(
        phase=jnp.where(lengths >= L, INIT, DONE).astype(jnp.int32),
        pos=z, jc=z, end=z,
        frs=z, fos=z, fre=z, foe=z,
        rrs=z, ros=z, rre=z, roe=z,
        ends=jnp.zeros((lanes, W), jnp.int32),
        counts=jnp.zeros((lanes, W), jnp.int32),
    )


@partial(jax.jit, static_argnums=(3, 4))
def _mem_scan(mi: FusedMemIndex, alphas: jax.Array, state, L: int,
              ticks: int):
    """alphas: int32 [lanes, W] in READ order (-1 illegal); lengths
    folded into the initial phase.  Resumable."""
    si = mi.si
    sigma = si.sigma
    r = si.r
    lanes, W = alphas.shape
    lane_iota = jnp.arange(lanes)

    def char_at(p):
        # one-hot for typical widths (see _char_select)
        return _char_select(alphas, lane_iota, p)

    m = jnp.sum(alphas > -2, axis=1).astype(jnp.int32)  # per-lane length

    def tick(state, _):
        phase = state["phase"]
        pos, jc, end = state["pos"], state["jc"], state["end"]
        frs, fos, fre, foe = (state["frs"], state["fos"], state["fre"],
                              state["foe"])
        rrs, ros, rre, roe = (state["rrs"], state["ros"], state["rre"],
                              state["roe"])

        # ---------------- INIT: anchor the window, init bidirectional
        is_init = phase == INIT
        past_end = pos + L > m
        c0 = char_at(pos + L - 1)
        i_frs, i_fos, i_fre, i_foe = _init_interval_oh(si, c0)
        c0r = jnp.where(c0 >= 0, sigma - 1 - c0, -1)
        i_rrs, i_ros, i_rre, i_roe = _init_interval_oh(si, c0r)
        do_init = is_init & ~past_end & (c0 >= 0)
        # illegal window-end char: the fw init interval is empty, so the
        # first extend_left fails at j=0 and the scan re-anchors at
        # init_pos - 0 + 1 = pos + L - 1 (mem_finder.cpp:58-60 with the
        # canonical empty interval)
        init_illegal = is_init & ~past_end & (c0 < 0)
        frs = jnp.where(do_init, i_frs, frs)
        fos = jnp.where(do_init, i_fos, fos)
        fre = jnp.where(do_init, i_fre, fre)
        foe = jnp.where(do_init, i_foe, foe)
        rrs = jnp.where(do_init, i_rrs, rrs)
        ros = jnp.where(do_init, i_ros, ros)
        rre = jnp.where(do_init, i_rre, rre)
        roe = jnp.where(do_init, i_roe, roe)
        jc = jnp.where(do_init, 0, jc)
        phase = jnp.where(do_init, BACK, phase)
        phase = jnp.where(is_init & past_end, DONE, phase)
        pos = jnp.where(init_illegal, pos + L - 1, pos)

        # ---------------- one backward step, phase-selected
        in_back = phase == BACK
        in_fwd = phase == FWD
        in_next = phase == NEXT
        # BACK char: seq[pos+L-2-jc]; FWD char: comp(seq[jc]) stepping rc;
        # NEXT char: seq[end-1-jc]
        c_back = char_at(pos + L - 2 - jc)
        # FWD complements the raw read char; unknown chars complement to
        # 'A' (utils.cpp:87-91), so N extends as 'A' here.  -3 marks '#'
        # (its own complement, never in an ACGT alphabet).
        c_fwd_raw = char_at(jc)
        c_fwd = jnp.where(c_fwd_raw >= 0, sigma - 1 - c_fwd_raw,
                          jnp.where(c_fwd_raw == -1, 0, -1))
        c_next = char_at(end - 1 - jc)
        a = jnp.where(in_back, c_back,
                      jnp.where(in_fwd, c_fwd, c_next))
        # FWD with i >= m: treated as an immediate failed step
        fwd_at_end = in_fwd & (jc >= m)
        a = jnp.where(fwd_at_end, -1, a)

        iv_rs = jnp.where(in_fwd, rrs, frs)
        iv_os = jnp.where(in_fwd, ros, fos)
        iv_re = jnp.where(in_fwd, rre, fre)
        iv_oe = jnp.where(in_fwd, roe, foe)
        active = in_back | in_fwd | in_next
        nrs, nos, nre, noe, empty = fused_bs_step(
            si, iv_rs, iv_os, iv_re, iv_oe, jnp.where(active, a, -1))
        ok = active & ~empty

        # ---------------- BACK: extend_left bookkeeping (rc update)
        back_ok = in_back & ok
        t = jnp.clip(sigma - 1 - c_back, 0, sigma - 1)
        sr_s = jnp.take(mi.skip_rec, t * r + jnp.minimum(frs, r - 1), axis=0)
        sr_e = jnp.take(mi.skip_rec, t * r + jnp.minimum(fre, r - 1), axis=0)
        skip = (sr_e[:, 0] + sr_e[:, 1] * (foe + 1)
                - sr_s[:, 0] - sr_s[:, 1] * fos)
        new_cnt = _count(si.all_p, nrs, nos, nre, noe)
        rc_start_abs = jnp.take(si.all_p, rrs, axis=0) + ros + skip
        n_rrs, n_ros = _resolve_mi(mi, rc_start_abs)
        n_rre, n_roe = _resolve_mi(mi, rc_start_abs + new_cnt - 1)

        frs2 = jnp.where(back_ok, nrs, frs)
        fos2 = jnp.where(back_ok, nos, fos)
        fre2 = jnp.where(back_ok, nre, fre)
        foe2 = jnp.where(back_ok, noe, foe)
        rrs2 = jnp.where(back_ok, n_rrs, rrs)
        ros2 = jnp.where(back_ok, n_ros, ros)
        rre2 = jnp.where(back_ok, n_rre, rre)
        roe2 = jnp.where(back_ok, n_roe, roe)
        # BACK failure at step jc: re-anchor at (pos+L-2) - jc + 1
        back_fail = in_back & ~ok
        pos2 = jnp.where(back_fail, pos + L - 1 - jc, pos)
        phase2 = jnp.where(back_fail, INIT, phase)
        # BACK completion: window fully matched -> FWD from i = pos+L
        jc2 = jnp.where(back_ok, jc + 1, jc)
        back_done = back_ok & (jc2 >= L - 1)
        phase2 = jnp.where(back_done, FWD, phase2)
        jc2 = jnp.where(back_done, pos + L, jc2)

        # ---------------- FWD: plain steps on rc; emit on failure
        fwd_ok = in_fwd & ok
        rrs2 = jnp.where(fwd_ok, nrs, rrs2)
        ros2 = jnp.where(fwd_ok, nos, ros2)
        rre2 = jnp.where(fwd_ok, nre, rre2)
        roe2 = jnp.where(fwd_ok, noe, roe2)
        jc2 = jnp.where(fwd_ok, jc + 1, jc2)
        fwd_fail = in_fwd & ~ok
        mem_count = _count(si.all_p, rrs, ros, rre, roe)
        ends = _emit_add(state["ends"], lane_iota, pos,
                         jnp.where(fwd_fail, jc, 0))
        counts = _emit_add(state["counts"], lane_iota, pos,
                           jnp.where(fwd_fail, mem_count, 0))
        # after emitting at end = i: NEXT scan (or DONE at read end)
        end2 = jnp.where(fwd_fail, jc, end)
        at_read_end = fwd_fail & (jc >= m)
        phase2 = jnp.where(fwd_fail, NEXT, phase2)
        phase2 = jnp.where(at_read_end, DONE, phase2)
        # NEXT init: fw = init(seq[end]) (init_search at end_pos), jc = 0
        go_next = fwd_fail & ~at_read_end
        c_end = char_at(end2)
        nx_rs, nx_os, nx_re, nx_oe = _init_interval_oh(si, c_end)
        # illegal char at end: the init interval is empty -> the first
        # NEXT step fails with jc=0 -> pos = end
        frs2 = jnp.where(go_next, nx_rs, frs2)
        fos2 = jnp.where(go_next, nx_os, fos2)
        fre2 = jnp.where(go_next, nx_re, fre2)
        foe2 = jnp.where(go_next, nx_oe, foe2)
        jc2 = jnp.where(go_next, 0, jc2)
        next_init_illegal = go_next & (c_end < 0)

        # ---------------- NEXT: backward-scan to the next candidate
        next_ok = in_next & ok
        # the scan is bounded: jc <= end - pos - 2
        exhausted = in_next & (jc > end - pos - 2)
        next_fail = (in_next & ~ok & ~exhausted) | next_init_illegal
        frs2 = jnp.where(next_ok & ~exhausted, nrs, frs2)
        fos2 = jnp.where(next_ok & ~exhausted, nos, fos2)
        fre2 = jnp.where(next_ok & ~exhausted, nre, fre2)
        foe2 = jnp.where(next_ok & ~exhausted, noe, foe2)
        jc2 = jnp.where(next_ok & ~exhausted, jc + 1, jc2)
        stop = next_fail | exhausted
        pos2 = jnp.where(stop & in_next, end - jc, pos2)
        pos2 = jnp.where(next_init_illegal, end2, pos2)
        phase2 = jnp.where(stop | next_init_illegal, INIT, phase2)

        new_state = dict(phase=phase2, pos=pos2, jc=jc2, end=end2,
                         frs=frs2, fos=fos2, fre=fre2, foe=foe2,
                         rrs=rrs2, ros=ros2, rre=rre2, roe=roe2,
                         ends=ends, counts=counts)
        return new_state, None

    state, _ = jax.lax.scan(tick, state, None, length=ticks)
    return state, jnp.all(state["phase"] == DONE)


def _extend_bidir(mi: FusedMemIndex, srs, sos, sre, soe,
                  ors, oos, ore, ooe, a_step):
    """One extend_bidirectional (move_structure_search.cpp:66-120):
    backward-step the (s*) interval with char a_step, advance the (o*)
    interval by the skip count.  Returns (ok, new_s*, new_o*)."""
    si = mi.si
    sigma, r = si.sigma, si.r
    nrs, nos, nre, noe, empty = fused_bs_step(si, srs, sos, sre, soe, a_step)
    ok = ~empty
    t = jnp.clip(sigma - 1 - a_step, 0, sigma - 1)
    sr_s = jnp.take(mi.skip_rec, t * r + jnp.minimum(srs, r - 1), axis=0)
    sr_e = jnp.take(mi.skip_rec, t * r + jnp.minimum(sre, r - 1), axis=0)
    skip = (sr_e[:, 0] + sr_e[:, 1] * (soe + 1)
            - sr_s[:, 0] - sr_s[:, 1] * sos)
    new_cnt = _count(si.all_p, nrs, nos, nre, noe)
    o_start_abs = jnp.take(si.all_p, ors, axis=0) + oos + skip
    n_ors, n_oos = _resolve_mi(mi, o_start_abs)
    n_ore, n_ooe = _resolve_mi(mi, o_start_abs + new_cnt - 1)
    return ok, nrs, nos, nre, noe, n_ors, n_oos, n_ore, n_ooe


# all-MEMs phases
AM_RIGHT, AM_LEFT, AM_DONE = 0, 1, 2


@partial(jax.jit, static_argnums=(2,))
def _all_mem_scan(mi: FusedMemIndex, alphas: jax.Array, ticks: int, state):
    """query_all_mems (mem_finder.cpp:105-145): right-extend to
    maximality, emit, re-anchor by left-extending from the MEM end."""
    si = mi.si
    sigma = si.sigma
    lanes, W = alphas.shape
    lane_iota = jnp.arange(lanes)
    m = jnp.sum(alphas > -2, axis=1).astype(jnp.int32)

    def char_at(p):
        # one-hot for typical widths (see _char_select)
        return _char_select(alphas, lane_iota, p)

    def init_pair(c0):
        """init_bidirectional at a char: fw from c0 (canonical empty
        interval (1,0,0,0) when illegal), rc from its complement
        (complement of any unknown-but-'#' char is 'A',
        utils.cpp:87-91)."""
        i_frs, i_fos, i_fre, i_foe = _init_interval_oh(si, c0)
        legal = c0 >= 0
        frs = jnp.where(legal, i_frs, 1)
        fos = jnp.where(legal, i_fos, 0)
        fre = jnp.where(legal, i_fre, 0)
        foe = jnp.where(legal, i_foe, 0)
        c0r = jnp.where(legal, sigma - 1 - c0, jnp.where(c0 == -1, 0, -1))
        i_rrs, i_ros, i_rre, i_roe = _init_interval_oh(si, c0r)
        rlegal = c0r >= 0
        rrs = jnp.where(rlegal, i_rrs, 1)
        ros = jnp.where(rlegal, i_ros, 0)
        rre = jnp.where(rlegal, i_rre, 0)
        roe = jnp.where(rlegal, i_roe, 0)
        return frs, fos, fre, foe, rrs, ros, rre, roe

    def tick(state, _):
        phase = state["phase"]
        s, ml, e = state["s"], state["ml"], state["e"]
        frs, fos, fre, foe = (state["frs"], state["fos"], state["fre"],
                              state["foe"])
        rrs, ros, rre, roe = (state["rrs"], state["ros"], state["rre"],
                              state["roe"])

        in_right = phase == AM_RIGHT
        in_left = phase == AM_LEFT

        # RIGHT: extend_right(seq[s+ml]) = extend_bidirectional on rc
        # with the complemented char; LEFT: extend_left(seq[e-ml]) on fw
        c_r_raw = char_at(s + ml)
        a_right = jnp.where(c_r_raw >= 0, sigma - 1 - c_r_raw,
                            jnp.where(c_r_raw == -1, 0, -1))
        a_left = char_at(e - ml)
        right_in_range = in_right & (s + ml < m)
        left_in_range = in_left & (e - ml >= 0)
        a = jnp.where(in_right, jnp.where(right_in_range, a_right, -1),
                      jnp.where(left_in_range, a_left, -1))
        step_rs = jnp.where(in_right, rrs, frs)
        step_os = jnp.where(in_right, ros, fos)
        step_re = jnp.where(in_right, rre, fre)
        step_oe = jnp.where(in_right, roe, foe)
        oth_rs = jnp.where(in_right, frs, rrs)
        oth_os = jnp.where(in_right, fos, ros)
        oth_re = jnp.where(in_right, fre, rre)
        oth_oe = jnp.where(in_right, foe, roe)
        (ok, n_srs, n_sos, n_sre, n_soe,
         n_ors, n_oos, n_ore, n_ooe) = _extend_bidir(
            mi, step_rs, step_os, step_re, step_oe,
            oth_rs, oth_os, oth_re, oth_oe, a)

        right_ok = in_right & ok
        left_ok = in_left & ok
        frs2 = jnp.where(right_ok, n_ors, jnp.where(left_ok, n_srs, frs))
        fos2 = jnp.where(right_ok, n_oos, jnp.where(left_ok, n_sos, fos))
        fre2 = jnp.where(right_ok, n_ore, jnp.where(left_ok, n_sre, fre))
        foe2 = jnp.where(right_ok, n_ooe, jnp.where(left_ok, n_soe, foe))
        rrs2 = jnp.where(right_ok, n_srs, jnp.where(left_ok, n_ors, rrs))
        ros2 = jnp.where(right_ok, n_sos, jnp.where(left_ok, n_oos, ros))
        rre2 = jnp.where(right_ok, n_sre, jnp.where(left_ok, n_ore, rre))
        roe2 = jnp.where(right_ok, n_soe, jnp.where(left_ok, n_ooe, roe))
        ml2 = jnp.where(right_ok | left_ok, ml + 1, ml)

        # RIGHT termination: emit (s, s+ml, count(fw)) at index s
        right_stop = in_right & ~right_ok & (phase != AM_DONE)
        mem_cnt = _count(si.all_p, frs, fos, fre, foe)
        ends = _emit_add(state["ends"], lane_iota, s,
                         jnp.where(right_stop, s + ml, 0))
        counts = _emit_add(state["counts"], lane_iota, s,
                           jnp.where(right_stop, mem_cnt, 0))
        e2 = jnp.where(right_stop, s + ml, e)
        at_end = right_stop & (s + ml >= m)
        phase2 = jnp.where(at_end, AM_DONE, phase)
        # re-anchor: init at e, ml = 1, left-extend
        reanchor = right_stop & ~at_end
        c_e = char_at(e2)
        (i_frs, i_fos, i_fre, i_foe,
         i_rrs, i_ros, i_rre, i_roe) = init_pair(c_e)
        frs2 = jnp.where(reanchor, i_frs, frs2)
        fos2 = jnp.where(reanchor, i_fos, fos2)
        fre2 = jnp.where(reanchor, i_fre, fre2)
        foe2 = jnp.where(reanchor, i_foe, foe2)
        rrs2 = jnp.where(reanchor, i_rrs, rrs2)
        ros2 = jnp.where(reanchor, i_ros, ros2)
        rre2 = jnp.where(reanchor, i_rre, rre2)
        roe2 = jnp.where(reanchor, i_roe, roe2)
        ml2 = jnp.where(reanchor, 1, ml2)
        phase2 = jnp.where(reanchor, AM_LEFT, phase2)

        # LEFT termination: s = e - ml + 1, back to RIGHT
        left_stop = in_left & ~left_ok
        s2 = jnp.where(left_stop, e - ml + 1, s)
        phase2 = jnp.where(left_stop, AM_RIGHT, phase2)

        new_state = dict(phase=phase2, s=s2, ml=ml2, e=e2,
                         frs=frs2, fos=fos2, fre=fre2, foe=foe2,
                         rrs=rrs2, ros=ros2, rre=rre2, roe=roe2,
                         ends=ends, counts=counts)
        return new_state, None

    state, _ = jax.lax.scan(tick, state, None, length=ticks)
    return state, jnp.all(state["phase"] == AM_DONE)



# ---------------------------------------------------------------------------
# Lane compaction for the resumable tick machines: a lockstep scan pays
# the WORST lane's tick count (stragglers with many short windows need
# ~10x the typical lane's ticks).  After each tick quantum, retired
# lanes' emissions fold into the full-size output and the scan resumes
# on a power-of-two bucket of survivors, so the straggler tail costs
# its own bucket, not the whole batch.

_MIN_BUCKET = 512


def _fold_emissions(state, cur_idx, fulls, emit_keys):
    idx_d = jnp.asarray(cur_idx)
    return tuple(full.at[idx_d].add(state[k])
                 for full, k in zip(fulls, emit_keys))


def _compact_state(state, al_full, cur_idx, alive, pad_to, done_phase,
                   emit_keys):
    """Rebuild the scan state on the `alive` bucket positions, padded
    with duplicate (phase-DONE, zero-emission) lanes to pad_to."""
    n = len(alive)
    sel = np.concatenate([alive, np.zeros(pad_to - n, np.int64)])
    sel_d = jnp.asarray(sel)
    new_state = {}
    for k, v in state.items():
        if k in emit_keys:
            new_state[k] = jnp.zeros((pad_to,) + v.shape[1:], v.dtype)
        else:
            new_state[k] = jnp.take(v, sel_d, axis=0)
    live = jnp.asarray(np.arange(pad_to) < n)
    new_state["phase"] = jnp.where(live, new_state["phase"], done_phase)
    new_idx = cur_idx[sel]
    return new_state, jnp.take(al_full, jnp.asarray(new_idx), axis=0), new_idx


def _resume_compacted(scan_step, state, al_full, lanes, W, done_phase,
                      max_iters, emit_keys=("ends", "counts"),
                      label="MEM"):
    """Run scan_step(al, state) quanta to convergence with compaction.
    Returns the emission buffers as [lanes, W] numpy arrays, in
    emit_keys order."""
    fulls = tuple(jnp.zeros((lanes,) + state[k].shape[1:], state[k].dtype)
                  for k in emit_keys)
    cur_idx = np.arange(lanes)
    al_cur = al_full
    done = False
    for _ in range(max_iters):
        state, d = scan_step(al_cur, state)
        if bool(d):
            done = True
            break
        phase = np.asarray(state["phase"])
        alive = np.flatnonzero(phase != done_phase)
        bucket = len(phase)
        target = max(_MIN_BUCKET,
                     1 << int(np.ceil(np.log2(max(len(alive), 1)))))
        if target <= bucket // 2:
            fulls = _fold_emissions(state, cur_idx, fulls, emit_keys)
            state, al_cur, cur_idx = _compact_state(
                state, al_full, cur_idx, alive, target, done_phase,
                emit_keys)
    assert done, f"{label} scan did not converge"
    fulls = _fold_emissions(state, cur_idx, fulls, emit_keys)
    return tuple(np.asarray(f) for f in fulls)


class FusedAllMemEngine:
    """Batched device all-MEMs (min_mem_length <= 1).  Results identical
    to AdvancedEngine.query_all_mems with ftab_k=0."""

    def __init__(self, mi: FusedMemIndex):
        self.mi = mi

    def query_batch(self, batch: ReadBatch
                    ) -> List[List[Tuple[int, int, int]]]:
        si = self.mi.si
        sigma = si.sigma
        W, lanes = batch.width, batch.lanes
        amap = si.alphamap_query.copy()
        amap[ord("#")] = -3
        from ..io.fastx import left_aligned_slots

        al = jnp.asarray(left_aligned_slots(batch, amap)
                         .astype(np.int8)).astype(jnp.int32)
        lengths = jnp.asarray(batch.lengths.astype(np.int32))
        z = jnp.zeros((lanes,), jnp.int32)
        # entry = init_bidirectional at s=0 with ml=1, phase RIGHT
        c0 = al[:, 0]
        import jax as _jax

        def make_state():
            i_frs, i_fos, i_fre, i_foe = _init_interval_oh(si, c0)
            legal = c0 >= 0
            c0r = jnp.where(legal, sigma - 1 - c0,
                            jnp.where(c0 == -1, 0, -1))
            i_rrs, i_ros, i_rre, i_roe = _init_interval_oh(si, c0r)
            rlegal = c0r >= 0
            return dict(
                phase=jnp.where(lengths > 0, AM_RIGHT, AM_DONE
                                ).astype(jnp.int32),
                s=z, ml=jnp.ones((lanes,), jnp.int32), e=z,
                frs=jnp.where(legal, i_frs, 1).astype(jnp.int32),
                fos=jnp.where(legal, i_fos, 0).astype(jnp.int32),
                fre=jnp.where(legal, i_fre, 0).astype(jnp.int32),
                foe=jnp.where(legal, i_foe, 0).astype(jnp.int32),
                rrs=jnp.where(rlegal, i_rrs, 1).astype(jnp.int32),
                ros=jnp.where(rlegal, i_ros, 0).astype(jnp.int32),
                rre=jnp.where(rlegal, i_rre, 0).astype(jnp.int32),
                roe=jnp.where(rlegal, i_roe, 0).astype(jnp.int32),
                ends=jnp.zeros((lanes, W), jnp.int32),
                counts=jnp.zeros((lanes, W), jnp.int32),
            )

        state = _jax.jit(make_state)()
        ticks = 4 * W + 64
        ends, counts = _resume_compacted(
            lambda a, st: _all_mem_scan(self.mi, a, ticks, st),
            state, al, lanes, W, AM_DONE, max_iters=W)
        res = []
        for i in range(lanes):
            nz = np.flatnonzero(ends[i])
            res.append([(int(p), int(ends[i][p]), int(counts[i][p]))
                        for p in nz])
        return res


class FusedMemEngine:
    """Batched device MEMs.  Results identical to
    AdvancedEngine.query_mems(seq, L) with ftab_k=0, for L >= 2."""

    def __init__(self, mi: FusedMemIndex, min_mem_length: int):
        assert min_mem_length >= 2, "use query_all_mems for L <= 1"
        self.mi = mi
        self.L = min_mem_length

    def query_batch(self, batch: ReadBatch
                    ) -> List[List[Tuple[int, int, int]]]:
        W, lanes = batch.width, batch.lanes
        amap = self.mi.si.alphamap_query.copy()
        amap[ord("#")] = -3  # '#' complements to itself (never matches)
        from ..io.fastx import left_aligned_slots

        al = jnp.asarray(left_aligned_slots(batch, amap)
                         .astype(np.int8)).astype(jnp.int32)
        state = make_mem_state(
            lanes, W, jnp.asarray(batch.lengths.astype(np.int32)), self.L)
        ticks = 4 * W + 64
        ends, counts = _resume_compacted(
            lambda a, st: _mem_scan(self.mi, a, st, self.L, ticks),
            state, al, lanes, W, DONE, max_iters=W)
        res = []
        for i in range(lanes):
            nz = np.flatnonzero(ends[i])
            res.append([(int(p), int(ends[i][p]), int(counts[i][p]))
                        for p in nz])
        return res
