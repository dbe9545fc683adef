"""Device MEM finder v2: ONE 32 B record gather per tick.

The v1 tick machine (engine/fused_mem.py) spends ~10 gathered rows per
tick: 2 record rows + 2 bidirectional-skip rows + 2 pos2rba reposition
rows + interval-count `all_p` rows.  Three observations collapse all of
that into one gather of two 32 B rows from a single combined table:

  1. The bidirectional skip fields are a pure function of the record's
     own (char, run) key: skip needs (P, u) at threshold t = comp(a)
     evaluated at the CURRENT interval runs -- exactly the rows the
     backward-step gather already fetches.  Embedding (P_t[run],
     u_t[run]) in the (a, run) record makes skip free, for BOTH
     extension directions (extend_left steps fw with a and needs
     t = comp(a); extend_right steps rc with comp(c) and needs t = c --
     both equal sigma-1-key_char).
  2. Absolute coordinates come free from the LF decode: embedding
     all_p[id] in the record gives the stepped endpoint's absolute BWT
     position as one add, so interval counts need no all_p gathers and
     the rc interval can be carried PURELY in absolute coordinates
     through the whole BACK phase (rc_abs += skip per step).
  3. The rc run/offset form is only needed when the FWD phase starts,
     so the reposition happens ONCE per window in a dedicated RESOLVE
     tick -- and the pos2rba rows are appended to the SAME table as the
     records, so a RESOLVE tick's gather is just different keys into
     the one gather every tick issues (a lockstep machine pays every
     gather in its body for every lane on every tick; one table means
     there is only one).

Result: ~2 gathered 32 B rows per tick in every phase (INIT and the
emissions stay one-hot elementwise work), vs ~10 mixed rows in v1
(docs/PERF.md section 2b).  Table: 8 int32 words x
(2*sigma*r + n) rows.  Absolute positions are int32: n < 2^31.

Bit-exact against AdvancedEngine.query_mems with ftab_k=0
(tests/test_fused_mem2.py) and against the v1 engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .fused_search import _char_select, _emit_add, _onehot_rows
from ..index.structure import MoveIndex
from ..io.fastx import ReadBatch

_GUARD = 0xFFFF

# phases
INIT, BACK, RESOLVE, FWD, NEXT, DONE, BSCAN = 0, 1, 2, 3, 4, 5, 6


@dataclass
class FusedMem2Index:
    r: int
    sigma: int
    n: int
    # rows [0, sigma*r): "down" records; [sigma*r, 2*sigma*r): "up"
    # records; [2*sigma*r, 2*sigma*r + n): pos2rba rows (w0 = run,
    # w1 = all_p[run]); optionally [.., .. + 4^ftab_k): ftab anchor rows
    # (rs, os, re, oe, abs_s, count, rc_abs_s, valid) -- ONE table so
    # every tick stays ONE gather
    rec_all: jax.Array       # int32 [2*sigma*r + n (+ 4^fk), 8]
    # init_rec6[a+1] = (rs, os, re, oe, abs_s, abs_e)
    init_rec6: jax.Array     # int32 [sigma+2, 6]
    alphamap_query: np.ndarray
    ftab_k: int = 0
    # abs position of the canonical empty interval's start (run 1,
    # offset 0) = all_p[1]: the oracle's bidirectional arithmetic keeps
    # advancing an "empty" fw side from its true absolute coordinates
    p1: int = 1


jax.tree_util.register_dataclass(
    FusedMem2Index,
    data_fields=["rec_all", "init_rec6", "alphamap_query"],
    meta_fields=["r", "sigma", "n", "ftab_k", "p1"],
)


def build_ftab_rows(ix: MoveIndex, fk: int,
                    rc_merge: bool = True) -> np.ndarray:
    """[4^fk, 8] int32 anchor rows per fk-mer code (kmer_to_number bit
    order, utils.cpp:120-139): (rs, os, re, oe, abs_s, count, rc_abs_s,
    valid).  Built level-by-level with vectorized backward-search steps
    (replaces the reference's per-code loop, move_structure_build.cpp:
    1121-1171).

    The rc interval start is TRACKED through the levels with the same
    bidirectional skip recurrence the scalar oracle uses (rc_abs +=
    skip over the pre-step fw interval), NOT looked up as the
    reverse-complement code's own interval: on a multi-document
    no-separator reference the k-mers spanning document junctions have
    no rc partners, so the true rc interval differs from the oracle's
    incremental arithmetic by the junction asymmetry -- the anchor must
    reproduce the ORACLE's state, junctions and all (the reference
    documents the same caveat, sequitur.cpp:7-9).

    rc_merge is retained for callers that only accept rows whose rc
    fk-mer also exists; the membership anchors (fw-only) pass False so
    forward-only indexes keep their rows."""
    r, sigma = ix.r, ix.sigma
    assert sigma == 4
    nu, nd = ix.next_tables_search()
    id_a = ix.id_arr.astype(np.int64)
    off_a = ix.offset_arr.astype(np.int64)
    n_a = ix.n_arr.astype(np.int64)
    all_p = ix.all_p
    from ..cpu_ref.native_search import build_skip_tables

    P_tab, U_tab = build_skip_tables(ix)

    def lf(run, off):
        run2 = id_a[run]
        off2 = off_a[run] + off
        ff = (off2 >= n_a[run2]) & (run2 < r - 1)  # bound_ff=1
        off2 = off2 - np.where(ff, n_a[run2], 0)
        return run2 + ff, off2

    rs = ix.first_runs[1:5].astype(np.int64).copy()
    os_ = ix.first_offsets[1:5].astype(np.int64).copy()
    re = ix.last_runs[1:5].astype(np.int64).copy()
    oe = ix.last_offsets[1:5].astype(np.int64).copy()
    # rc side init: abs of comp(a)'s init interval (init_bidirectional)
    comp_first = ix.first_runs[1:5][::-1]
    comp_foff = ix.first_offsets[1:5][::-1]
    rc_abs = (all_p[np.clip(comp_first, 0, r - 1)]
              + comp_foff).astype(np.int64)
    valid = np.ones(4, dtype=bool)
    for _level in range(2, fk + 1):
        rs_t, os_t, re_t, oe_t, v_t, ra_t = [], [], [], [], [], []
        for a in range(4):
            d = nd[a][np.clip(rs, 0, r - 1)]
            ok = valid & (d < r) & (d <= re)
            dc = np.clip(d, 0, r - 1)
            o1 = np.where(d == rs, os_, 0)
            e2 = np.clip(nu[a][np.clip(re, 0, r - 1)], 0, r - 1)
            o2 = np.where(e2 == re, oe, n_a[e2] - 1)
            nrs, nos = lf(dc, o1)
            nre, noe = lf(e2, o2)
            # extend_left's rc advance: skip over the PRE-step fw
            # interval at threshold t = comp(a)
            t = sigma - 1 - a
            rsc = np.clip(rs, 0, r - 1)
            rec = np.clip(re, 0, r - 1)
            skip = (P_tab[t][rec] + U_tab[t][rec] * (oe + 1)
                    - P_tab[t][rsc] - U_tab[t][rsc] * os_)
            rs_t.append(np.where(ok, nrs, 1))
            os_t.append(np.where(ok, nos, 0))
            re_t.append(np.where(ok, nre, 0))
            oe_t.append(np.where(ok, noe, 0))
            ra_t.append(np.where(ok, rc_abs + skip, 0))
            v_t.append(ok)
        rs, os_ = np.concatenate(rs_t), np.concatenate(os_t)
        re, oe = np.concatenate(re_t), np.concatenate(oe_t)
        rc_abs = np.concatenate(ra_t)
        valid = np.concatenate(v_t)
    fabs = np.where(valid, all_p[np.clip(rs, 0, r - 1)] + os_, 0)
    cnt = np.where(valid,
                   all_p[np.clip(re, 0, r - 1)] + oe - fabs + 1, 0)
    if rc_merge:
        codes = np.arange(4 ** fk, dtype=np.int64)
        rc = np.zeros_like(codes)
        tmp = codes.copy()
        for _ in range(fk):
            rc = (rc << 2) | (3 - (tmp & 3))
            tmp >>= 2
        valid = valid & valid[rc]
    return np.stack([rs, os_, re, oe, fabs, cnt,
                     np.where(valid, rc_abs, 0),
                     valid.astype(np.int64)], axis=1).astype(np.int32)


# past this total-position count the 32 B/position combined table is
# too large for one chip; callers fall back to the v1 machines (whose
# pos2rba is optional with a searchsorted fallback)
MEM2_MAX_N = 1 << 28


def mem2_supported(ix: MoveIndex) -> bool:
    """True when the v2 combined table fits: ACGT alphabet and
    n <= MEM2_MAX_N (the v1 engines remain the large-n fallback)."""
    return (bytes(ix.alphabet) == b"ACGT"
            and int(ix.all_p[-1]) <= MEM2_MAX_N)


def looks_rc_closed(ix: MoveIndex, fk: int = 6) -> bool:
    """Strong necessary test for reverse-complement closure: per-char
    counts are symmetric AND every fk-mer's occurrence count equals its
    reverse complement's (all 4^fk of them, via the vectorized level
    build).  The bidirectional engines require occ(s) == occ(rc(s)) for
    every string; a forward-only index -- or one that is merely
    count-symmetric, e.g. text + complement-without-reversal -- fails
    this at fk = 6 with overwhelming probability, where the old
    count-only test silently passed wrong inputs to the bidirectional
    k-mer counter."""
    if bytes(ix.alphabet) != b"ACGT":
        return False
    c = ix.counts
    if int(c[0]) != int(c[3]) or int(c[1]) != int(c[2]):
        return False
    fr = build_ftab_rows(ix, fk, rc_merge=False)
    cnt = np.where(fr[:, 7] == 1, fr[:, 5], -1).astype(np.int64)
    codes = np.arange(4 ** fk, dtype=np.int64)
    rc = np.zeros_like(codes)
    tmp = codes.copy()
    for _ in range(fk):
        rc = (rc << 2) | (3 - (tmp & 3))
        tmp >>= 2
    return bool((cnt == cnt[rc]).all())


def build_fused_mem2_index(ix: MoveIndex,
                           ftab_k: int = 0) -> FusedMem2Index:
    r, sigma = ix.r, ix.sigma
    assert bytes(ix.alphabet) == b"ACGT", (
        "device MEM engine requires the ACGT alphabet (complement is "
        "index-reversal)")
    assert int(ix.n_arr[ix.end_bwt_idx]) == 1, (
        "the '$' run must be a single row")
    n_total = int(ix.all_p[-1])
    assert n_total < (1 << 31), "absolute positions are int32"
    n64 = ix.n_arr.astype(np.int64)
    lf_abs = ix.all_p[ix.id_arr] + ix.offset_arr.astype(np.int64)
    e = lf_abs + n64 - 1
    id_end = np.searchsorted(ix.all_p[:-1], e, side="right") - 1
    assert int(np.max(id_end - ix.id_arr)) <= 1, (
        "fused MEM requires an index built with bound_ff=1")

    nus, nds = ix.next_tables_search()
    # bidirectional skip weights per threshold t (= comp of the record's
    # char): shared construction (cpu_ref/native_search.build_skip_tables
    # -- the '$'-row weighing rule is load-bearing, one copy only)
    from ..cpu_ref.native_search import build_skip_tables

    P_tab, U_tab = build_skip_tables(ix)

    def records(dest_tab):
        rec = np.zeros((sigma, r, 8), dtype=np.int64)
        for a in range(sigma):
            dest = dest_tab[a].astype(np.int64)
            ok = dest < r
            d = np.where(ok, dest, 0)
            idd = ix.id_arr[d]
            cum1 = np.where(idd < r - 1, n64[idd], _GUARD)
            t = sigma - 1 - a
            rec[a, :, 0] = np.where(ok, dest, r)
            rec[a, :, 1] = idd
            rec[a, :, 2] = cum1 | (ix.offset_arr[d].astype(np.int64) << 16)
            rec[a, :, 3] = n64[d]
            rec[a, :, 4] = ix.all_p[idd]
            rec[a, :, 5] = P_tab[t]
            rec[a, :, 6] = U_tab[t]
        return rec.reshape(sigma * r, 8).astype(np.int32)

    runs = np.repeat(np.arange(r, dtype=np.int64), n64)
    p2r = np.zeros((n_total, 8), dtype=np.int32)
    p2r[:, 0] = runs
    p2r[:, 1] = ix.all_p[:-1][runs]
    parts = [records(nds), records(nus), p2r]
    if ftab_k > 1:
        parts.append(build_ftab_rows(ix, ftab_k))
    rec_all = np.concatenate(parts)

    alphamap_query = np.full(256, -1, dtype=np.int32)
    for a, ch in enumerate(ix.alphabet):
        alphamap_query[ch] = a
    from ..constants import SEPARATOR
    if ix.separators:
        alphamap_query[SEPARATOR] = -1

    abs_s = ix.all_p[np.clip(ix.first_runs, 0, r - 1)] + ix.first_offsets
    abs_e = ix.all_p[np.clip(ix.last_runs, 0, r - 1)] + ix.last_offsets
    init6 = np.stack([ix.first_runs, ix.first_offsets, ix.last_runs,
                      ix.last_offsets, abs_s, abs_e], axis=1)
    return FusedMem2Index(
        r=r, sigma=sigma, n=n_total,
        rec_all=jnp.asarray(rec_all),
        init_rec6=jnp.asarray(init6.astype(np.int32)),
        alphamap_query=alphamap_query, ftab_k=ftab_k,
        p1=int(ix.all_p[1]))


def _init6(m2: FusedMem2Index, a):
    rec = _onehot_rows(m2.init_rec6, jnp.maximum(a, 0) + 1)
    return tuple(rec[:, i] for i in range(6))


def _decode_lf(rec, off_in):
    """LF + bounded ff from a wide record: returns (run', off', abs')."""
    w2 = rec[:, 2]
    off0 = (w2 >> 16) + off_in
    cum1 = w2 & _GUARD
    ff = (off0 >= cum1).astype(jnp.int32)
    return rec[:, 1] + ff, off0 - ff * cum1, rec[:, 4] + off0


def mem2_step(m2: FusedMem2Index, rs, os_, re, oe, a):
    """One backward_search_step on the wide records, outside the tick
    machine (used by the k-mer count engine's right-extension chain).

    Returns (nrs, nos, nre, noe, nabs_s, nabs_e, skip, empty); `skip`
    is the bidirectional advance of the companion interval computed
    from the embedded (P, u) fields at the PRE-step interval -- valid
    when `a` is the stepped direction's char (extend_left: a = fw char;
    extend_right: a = comp(text char) stepping the rc side)."""
    sigma, r = m2.sigma, m2.r
    lanes = rs.shape[0]
    a_s = jnp.maximum(a, 0)
    key_lo = a_s * r + jnp.clip(rs, 0, r - 1)
    key_hi = sigma * r + a_s * r + jnp.clip(re, 0, r - 1)
    both = jnp.take(m2.rec_all, jnp.concatenate([key_lo, key_hi]),
                    axis=0)
    lo, hi = both[:lanes], both[lanes:]
    drs = lo[:, 0]
    dre = hi[:, 0]
    empty = (a < 0) | (drs >= r) | (drs > re)
    os1 = jnp.where(drs != rs, 0, os_)
    oe1 = jnp.where(dre != re, hi[:, 3] - 1, oe)
    nrs, nos, nabs_s = _decode_lf(lo, os1)
    nre, noe, nabs_e = _decode_lf(hi, oe1)
    skip = (hi[:, 5] + hi[:, 6] * (oe + 1)
            - lo[:, 5] - lo[:, 6] * os_)
    return nrs, nos, nre, noe, nabs_s, nabs_e, skip, empty


def mem2_resolve(m2: FusedMem2Index, abs_pos):
    """(run, offset) of absolute BWT rows via the appended pos2rba
    rows: one gathered 32 B row each."""
    base = 2 * m2.sigma * m2.r
    row = jnp.take(m2.rec_all,
                   base + jnp.clip(abs_pos, 0, m2.n - 1), axis=0)
    return row[:, 0], abs_pos - row[:, 1]


@partial(jax.jit, static_argnums=(1, 2))
def _prep_alc(al8, fk: int, use_ftab: bool):
    """Device-side batch prep: widen the int8 slot matrix once (a
    quarter of the int32 upload) and, with ftab, derive the
    per-position fk-mer codes on device instead of shipping a second
    int32 [lanes, W] array."""
    al = al8.astype(jnp.int32)
    if not use_ftab:
        return al
    W = al.shape[1]
    code = jnp.zeros_like(al)
    ok = jnp.ones(al.shape, bool)
    for j in range(fk):
        sh = fk - 1 - j
        a_sh = jnp.pad(al, ((0, 0), (sh, 0)),
                       constant_values=-1)[:, :W]
        code = code * 4 + jnp.maximum(a_sh, 0)
        ok = ok & (a_sh >= 0)
    ok = ok & (jnp.arange(W) >= fk - 1)[None, :]
    return jnp.concatenate([al, jnp.where(ok, code, -1)], axis=1)


def make_mem2_state(lanes: int, W: int, lengths: jax.Array, L: int):
    z = jnp.zeros((lanes,), jnp.int32)
    return dict(
        phase=jnp.where(lengths >= L, INIT, DONE).astype(jnp.int32),
        pos=z, jc=z, end=z,
        frs=z, fos=z, fre=z, foe=z, fas=z, fae=z,
        rrs=z, ros=z, rre=z, roe=z, ras=z, rae=z,
        ends=jnp.zeros((lanes, W), jnp.int32),
        counts=jnp.zeros((lanes, W), jnp.int32),
    )


@partial(jax.jit, static_argnums=(3, 4, 5))
def _mem2_scan(m2: FusedMem2Index, alc: jax.Array, state, L: int,
               ticks: int, use_ftab: bool = False):
    """BML scan, one combined-table gather per tick.  alc: int32
    [lanes, W] read-order slots (-1 illegal, -3 '#', -2 beyond); with
    use_ftab, [lanes, 2W] -- slots next to per-position ftab codes
    (_prep_alc), kept in one array so lane compaction slices both.

    The ftab anchor (mem_finder.cpp:34-43): INIT gathers the window
    end's fk-mer row from the appended ftab rows (same combined table,
    still one gather per tick); a hit jumps the first fk BACK steps; a
    miss (absent fk-mer or illegal char in its span) runs the plain
    backward scan of the reference's ftab_skip path (BSCAN phase,
    mem_finder.cpp:44-56) to find the next anchor.  Emissions are
    unchanged -- extension failures happen at the same characters."""
    sigma, r = m2.sigma, m2.r
    P2R = 2 * sigma * r
    FTB = P2R + m2.n
    lanes = alc.shape[0]
    W = alc.shape[1] // 2 if use_ftab else alc.shape[1]
    alphas = alc[:, :W]
    lane_iota = jnp.arange(lanes)
    m = jnp.sum(alphas > -2, axis=1).astype(jnp.int32)

    def char_at(p):
        return _char_select(alphas, lane_iota, p)

    def code_at(p):
        return _char_select(alc[:, W:], lane_iota, p)

    def tick(state, _):
        phase = state["phase"]
        pos, jc, end = state["pos"], state["jc"], state["end"]
        frs, fos, fre, foe = (state["frs"], state["fos"], state["fre"],
                              state["foe"])
        fas, fae = state["fas"], state["fae"]
        rrs, ros, rre, roe = (state["rrs"], state["ros"], state["rre"],
                              state["roe"])
        ras, rae = state["ras"], state["rae"]

        # ---------------- INIT: anchor the window, init bidirectional
        is_init = phase == INIT
        past_end = pos + L > m
        c0 = char_at(pos + L - 1)
        i_f = _init6(m2, c0)
        c0r = jnp.where(c0 >= 0, sigma - 1 - c0, -1)
        i_r = _init6(m2, c0r)
        do_init = is_init & ~past_end & (c0 >= 0)
        init_illegal = is_init & ~past_end & (c0 < 0)
        if not use_ftab:
            # anchored lanes step in the SAME tick (fall into BACK)
            frs = jnp.where(do_init, i_f[0], frs)
            fos = jnp.where(do_init, i_f[1], fos)
            fre = jnp.where(do_init, i_f[2], fre)
            foe = jnp.where(do_init, i_f[3], foe)
            fas = jnp.where(do_init, i_f[4], fas)
            fae = jnp.where(do_init, i_f[5], fae)
            ras = jnp.where(do_init, i_r[4], ras)
            jc = jnp.where(do_init, 0, jc)
            phase = jnp.where(do_init, BACK, phase)
        else:
            # anchored lanes spend THIS tick gathering their ftab row
            code0 = code_at(pos + L - 1)
        phase = jnp.where(is_init & past_end, DONE, phase)
        pos = jnp.where(init_illegal, pos + L - 1, pos)

        # ---------------- the ONE gather, phase-keyed.  One phase-
        # selected char fetch serves every stepping phase (the [lanes,
        # W] one-hot selects are the tick's main elementwise cost; v1
        # spent 4+)
        in_back = phase == BACK
        in_resolve = phase == RESOLVE
        in_fwd = phase == FWD
        in_next = phase == NEXT
        in_bscan = (phase == BSCAN) if use_ftab \
            else jnp.zeros_like(in_back)
        backish = in_back | in_bscan
        p_step = jnp.where(backish, pos + L - 2 - jc,
                           jnp.where(in_fwd, jc, end - 1 - jc))
        c_raw = char_at(p_step)
        c_fwd = jnp.where(c_raw >= 0, sigma - 1 - c_raw,
                          jnp.where(c_raw == -1, 0, -1))
        a = jnp.where(in_fwd, c_fwd, c_raw)
        fwd_at_end = in_fwd & (jc >= m)
        a = jnp.where(fwd_at_end, -1, a)
        a_s = jnp.maximum(a, 0)

        iv_rs = jnp.where(in_fwd, rrs, frs)
        iv_os = jnp.where(in_fwd, ros, fos)
        iv_re = jnp.where(in_fwd, rre, fre)
        iv_oe = jnp.where(in_fwd, roe, foe)

        rae_want = ras + (fae - fas)  # rc end abs = start + count - 1
        key_lo = jnp.where(
            in_resolve, P2R + jnp.clip(ras, 0, m2.n - 1),
            a_s * r + jnp.minimum(jnp.maximum(iv_rs, 0), r - 1))
        key_hi = jnp.where(
            in_resolve, P2R + jnp.clip(rae_want, 0, m2.n - 1),
            sigma * r + a_s * r + jnp.minimum(jnp.maximum(iv_re, 0),
                                              r - 1))
        if use_ftab:
            fkey = FTB + jnp.maximum(code0, 0)
            key_lo = jnp.where(do_init, fkey, key_lo)
            key_hi = jnp.where(do_init, fkey, key_hi)
        both = jnp.take(m2.rec_all,
                        jnp.concatenate([key_lo, key_hi]), axis=0)
        lo, hi = both[:lanes], both[lanes:]

        # record decode (BACK / FWD / NEXT)
        drs = lo[:, 0]
        dre = hi[:, 0]
        empty = (a < 0) | (drs >= r) | (drs > iv_re)
        os1 = jnp.where(drs != iv_rs, 0, iv_os)
        oe1 = jnp.where(dre != iv_re, hi[:, 3] - 1, iv_oe)
        nrs, nos, nas = _decode_lf(lo, os1)
        nre, noe, nae = _decode_lf(hi, oe1)
        # bidirectional skip from the embedded (P, u) fields at the
        # PRE-step interval (valid in BACK, where a = the fw char)
        skip = (hi[:, 5] + hi[:, 6] * (iv_oe + 1)
                - lo[:, 5] - lo[:, 6] * iv_os)

        active = backish | in_fwd | in_next
        ok = active & ~empty

        # ---------------- BACK/BSCAN: extend_left; rc in abs only
        # (BSCAN steps fw identically but maintains no rc and cannot
        # complete -- the ftab miss guarantees a failure in the span)
        back_ok = backish & ok
        frs2 = jnp.where(back_ok, nrs, frs)
        fos2 = jnp.where(back_ok, nos, fos)
        fre2 = jnp.where(back_ok, nre, fre)
        foe2 = jnp.where(back_ok, noe, foe)
        fas2 = jnp.where(back_ok, nas, fas)
        fae2 = jnp.where(back_ok, nae, fae)
        ras2 = jnp.where(in_back & ok, ras + skip, ras)
        back_fail = backish & ~ok
        pos2 = jnp.where(back_fail, pos + L - 1 - jc, pos)
        phase2 = jnp.where(back_fail, INIT, phase)
        jc2 = jnp.where(back_ok, jc + 1, jc)
        back_done = (in_back & ok) & (jc2 >= L - 1)
        phase2 = jnp.where(back_done, RESOLVE, phase2)
        jc2 = jnp.where(back_done, pos + L, jc2)
        if use_ftab:
            # can't-happen guard (reference throws): a completed BSCAN
            # emits nothing and re-anchors one position right
            bscan_done = (in_bscan & ok) & (jc2 >= L - 1)
            phase2 = jnp.where(bscan_done, INIT, phase2)
            pos2 = jnp.where(bscan_done, pos + 1, pos2)

        # ---------------- RESOLVE: rc abs -> (run, offset), one tick
        res_rrs = lo[:, 0]
        res_ros = ras - lo[:, 1]
        res_rre = hi[:, 0]
        res_roe = rae_want - hi[:, 1]
        rrs2 = jnp.where(in_resolve, res_rrs, rrs)
        ros2 = jnp.where(in_resolve, res_ros, ros)
        rre2 = jnp.where(in_resolve, res_rre, rre)
        roe2 = jnp.where(in_resolve, res_roe, roe)
        rae2 = jnp.where(in_resolve, rae_want, rae)
        phase2 = jnp.where(in_resolve, FWD, phase2)

        # ---------------- FWD: plain steps on rc; emit on failure
        fwd_ok = in_fwd & ok
        rrs2 = jnp.where(fwd_ok, nrs, rrs2)
        ros2 = jnp.where(fwd_ok, nos, ros2)
        rre2 = jnp.where(fwd_ok, nre, rre2)
        roe2 = jnp.where(fwd_ok, noe, roe2)
        ras2 = jnp.where(fwd_ok, nas, ras2)
        rae2 = jnp.where(fwd_ok, nae, rae2)
        jc2 = jnp.where(fwd_ok, jc + 1, jc2)
        fwd_fail = in_fwd & ~ok
        mem_count = rae - ras + 1
        ends = _emit_add(state["ends"], lane_iota, pos,
                         jnp.where(fwd_fail, jc, 0))
        counts = _emit_add(state["counts"], lane_iota, pos,
                           jnp.where(fwd_fail, mem_count, 0))
        end2 = jnp.where(fwd_fail, jc, end)
        at_read_end = fwd_fail & (jc >= m)
        phase2 = jnp.where(fwd_fail, NEXT, phase2)
        phase2 = jnp.where(at_read_end, DONE, phase2)
        # NEXT init: fw = init(seq[end]), jc = 0.  For go_next lanes
        # (a FWD failure) end2 == jc == p_step, so the raw char fetched
        # above IS seq[end2] -- no second select needed.
        go_next = fwd_fail & ~at_read_end
        c_end = c_raw
        nx = _init6(m2, c_end)
        frs2 = jnp.where(go_next, nx[0], frs2)
        fos2 = jnp.where(go_next, nx[1], fos2)
        fre2 = jnp.where(go_next, nx[2], fre2)
        foe2 = jnp.where(go_next, nx[3], foe2)
        jc2 = jnp.where(go_next, 0, jc2)
        next_init_illegal = go_next & (c_end < 0)

        # ---------------- NEXT: backward-scan to the next candidate
        next_ok = in_next & ok
        exhausted = in_next & (jc > end - pos - 2)
        next_fail = (in_next & ~ok & ~exhausted) | next_init_illegal
        nok = next_ok & ~exhausted
        frs2 = jnp.where(nok, nrs, frs2)
        fos2 = jnp.where(nok, nos, fos2)
        fre2 = jnp.where(nok, nre, fre2)
        foe2 = jnp.where(nok, noe, foe2)
        jc2 = jnp.where(nok, jc + 1, jc2)
        stop = next_fail | exhausted
        pos2 = jnp.where(stop & in_next, end - jc, pos2)
        pos2 = jnp.where(next_init_illegal, end2, pos2)
        phase2 = jnp.where(stop | next_init_illegal, INIT, phase2)

        if use_ftab:
            # ---------------- ftab INIT landing (disjoint lanes)
            row = lo
            hit = do_init & (code0 >= 0) & (row[:, 7] == 1)
            miss = do_init & ~hit
            frs2 = jnp.where(hit, row[:, 0], jnp.where(miss, i_f[0],
                                                       frs2))
            fos2 = jnp.where(hit, row[:, 1], jnp.where(miss, i_f[1],
                                                       fos2))
            fre2 = jnp.where(hit, row[:, 2], jnp.where(miss, i_f[2],
                                                       fre2))
            foe2 = jnp.where(hit, row[:, 3], jnp.where(miss, i_f[3],
                                                       foe2))
            fas2 = jnp.where(hit, row[:, 4], fas2)
            fae2 = jnp.where(hit, row[:, 4] + row[:, 5] - 1, fae2)
            ras2 = jnp.where(hit, row[:, 6], ras2)
            if m2.ftab_k >= L:
                # the ftab row covers the whole window: no BACK steps
                jc2 = jnp.where(hit, pos + L, jnp.where(miss, 0, jc2))
                phase2 = jnp.where(hit, RESOLVE,
                                   jnp.where(miss, BSCAN, phase2))
            else:
                jc2 = jnp.where(hit, m2.ftab_k - 1,
                                jnp.where(miss, 0, jc2))
                phase2 = jnp.where(hit, BACK,
                                   jnp.where(miss, BSCAN, phase2))

        new_state = dict(phase=phase2, pos=pos2, jc=jc2, end=end2,
                         frs=frs2, fos=fos2, fre=fre2, foe=foe2,
                         fas=fas2, fae=fae2,
                         rrs=rrs2, ros=ros2, rre=rre2, roe=roe2,
                         ras=ras2, rae=rae2,
                         ends=ends, counts=counts)
        return new_state, None

    state, _ = jax.lax.scan(tick, state, None, length=ticks)
    return state, jnp.all(state["phase"] == DONE)


class FusedMem2Engine:
    """Batched device MEMs (BML) on the v2 one-gather-per-tick records.
    Results identical to AdvancedEngine.query_mems(seq, L) with
    ftab_k=0, for L >= 2."""

    def __init__(self, m2: FusedMem2Index, min_mem_length: int):
        assert min_mem_length >= 2, "use query_all_mems for L <= 1"
        self.m2 = m2
        self.L = min_mem_length

    def query_batch(self, batch: ReadBatch
                    ) -> List[List[Tuple[int, int, int]]]:
        from .fused_mem import _resume_compacted

        W, lanes = batch.width, batch.lanes
        amap = self.m2.alphamap_query.copy()
        amap[ord("#")] = -3  # '#' complements to itself (never matches)
        from ..io.fastx import left_aligned_slots

        al_np = left_aligned_slots(batch, amap)
        use_ftab = 1 < self.m2.ftab_k <= self.L
        # slots ship int8; the ftab codes are derived ON DEVICE and
        # share one array with the slots so the lane compaction slices
        # both together
        al = _prep_alc(jnp.asarray(al_np.astype(np.int8)),
                       self.m2.ftab_k if use_ftab else 0, use_ftab)
        state = make_mem2_state(
            lanes, W, jnp.asarray(batch.lengths.astype(np.int32)), self.L)
        import os as _os

        # quantum size: an untuned default (typical BML lanes converge
        # in ~2.5 W ticks with the ftab anchor; no GPU sweep yet).  The
        # compaction-resume loop guarantees completion for
        # straggler-heavy batches whatever the quantum.
        ticks = (int(_os.environ.get("MOVI_TPU_TICK_QUANTUM", 0))
                 or 2 * W + 84)
        ends, counts = _resume_compacted(
            lambda a, st: _mem2_scan(self.m2, a, st, self.L, ticks,
                                     use_ftab),
            state, al, lanes, W, DONE, max_iters=W, label="MEM2")
        res = []
        for i in range(lanes):
            nz = np.flatnonzero(ends[i])
            res.append([(int(p), int(ends[i][p]), int(counts[i][p]))
                        for p in nz])
        return res


def _init_pair6(m2: FusedMem2Index, c0):
    """init_bidirectional at a char: fw from c0 (canonical empty when
    illegal -- abs form (all_p[1], 0)), rc from its complement
    (unknown-but-'#' complements to 'A', utils.cpp:87-91); both with
    abs.  ONE copy of these oracle-dictated subtleties, shared by the
    all-MEMs scan body and its entry state."""
    sigma = m2.sigma
    i_f = _init6(m2, c0)
    legal = c0 >= 0
    fw = (jnp.where(legal, i_f[0], 1), jnp.where(legal, i_f[1], 0),
          jnp.where(legal, i_f[2], 0), jnp.where(legal, i_f[3], 0),
          jnp.where(legal, i_f[4], m2.p1),
          jnp.where(legal, i_f[5], 0))
    c0r = jnp.where(legal, sigma - 1 - c0,
                    jnp.where(c0 == -1, 0, -1))
    i_r = _init6(m2, c0r)
    rlegal = c0r >= 0
    rc = (jnp.where(rlegal, i_r[0], 1), jnp.where(rlegal, i_r[1], 0),
          jnp.where(rlegal, i_r[2], 0), jnp.where(rlegal, i_r[3], 0),
          jnp.where(rlegal, i_r[4], m2.p1),
          jnp.where(rlegal, i_r[5], 0))
    return fw, rc


# all-MEMs phases (query_all_mems, mem_finder.cpp:105-145)
AM2_RIGHT, AM2_LEFT, AM2_RES, AM2_DONE = 0, 1, 2, 3


@partial(jax.jit, static_argnums=(2,))
def _all_mem2_scan(m2: FusedMem2Index, alphas: jax.Array, ticks: int,
                   state):
    """query_all_mems on the v2 records: right-extend to maximality,
    emit, re-anchor by left-extending from the MEM end.  One combined-
    table gather and one [lanes, W] select per tick: the direction being
    STEPPED keeps (run, offset) -- its abs falls out of the record
    decode -- while the companion side is carried purely in ABSOLUTE
    coordinates via the embedded skip fields, resolved in one RES tick
    when the direction flips back to RIGHT (re-anchors reset both sides
    from the init tables, so LEFT entry needs no resolve)."""
    sigma, r = m2.sigma, m2.r
    P2R = 2 * sigma * r
    lanes, W = alphas.shape
    lane_iota = jnp.arange(lanes)
    m = jnp.sum(alphas > -2, axis=1).astype(jnp.int32)

    def char_at(p):
        return _char_select(alphas, lane_iota, p)

    def init_pair6(c0):
        return _init_pair6(m2, c0)

    def tick(state, _):
        phase = state["phase"]
        s, ml, e = state["s"], state["ml"], state["e"]
        frs, fos, fre, foe = (state["frs"], state["fos"], state["fre"],
                              state["foe"])
        fas, fae = state["fas"], state["fae"]
        rrs, ros, rre, roe = (state["rrs"], state["ros"], state["rre"],
                              state["roe"])
        ras, rae = state["ras"], state["rae"]

        in_right = phase == AM2_RIGHT
        in_left = phase == AM2_LEFT
        in_res = phase == AM2_RES

        # one select: RIGHT char at s+ml, LEFT char at e-ml
        p_sel = jnp.where(in_right, s + ml, e - ml)
        c_raw = char_at(p_sel)
        a_right = jnp.where(c_raw >= 0, sigma - 1 - c_raw,
                            jnp.where(c_raw == -1, 0, -1))
        right_in_range = in_right & (s + ml < m)
        left_in_range = in_left & (e - ml >= 0)
        a = jnp.where(in_right,
                      jnp.where(right_in_range, a_right, -1),
                      jnp.where(left_in_range, c_raw, -1))
        a_s = jnp.maximum(a, 0)

        iv_rs = jnp.where(in_right, rrs, frs)
        iv_os = jnp.where(in_right, ros, fos)
        iv_re = jnp.where(in_right, rre, fre)
        iv_oe = jnp.where(in_right, roe, foe)
        # RES uses the CARRIED rae, not ras + (fae - fas): after an
        # illegal-char re-anchor the fw side is the canonical empty
        # interval, so the count(fw) == count(rc) sync does not hold
        key_lo = jnp.where(
            in_res, P2R + jnp.clip(ras, 0, m2.n - 1),
            a_s * r + jnp.minimum(jnp.maximum(iv_rs, 0), r - 1))
        key_hi = jnp.where(
            in_res, P2R + jnp.clip(rae, 0, m2.n - 1),
            sigma * r + a_s * r + jnp.minimum(jnp.maximum(iv_re, 0),
                                              r - 1))
        both = jnp.take(m2.rec_all,
                        jnp.concatenate([key_lo, key_hi]), axis=0)
        lo, hi = both[:lanes], both[lanes:]
        drs = lo[:, 0]
        dre = hi[:, 0]
        empty = (a < 0) | (drs >= r) | (drs > iv_re)
        os1 = jnp.where(drs != iv_rs, 0, iv_os)
        oe1 = jnp.where(dre != iv_re, hi[:, 3] - 1, iv_oe)
        nrs, nos, nas = _decode_lf(lo, os1)
        nre, noe, nae = _decode_lf(hi, oe1)
        skip = (hi[:, 5] + hi[:, 6] * (iv_oe + 1)
                - lo[:, 5] - lo[:, 6] * iv_os)
        ok = (in_right | in_left) & ~empty

        right_ok = in_right & ok
        left_ok = in_left & ok
        # stepped side takes the decode; companion side advances in abs
        rrs2 = jnp.where(right_ok, nrs, rrs)
        ros2 = jnp.where(right_ok, nos, ros)
        rre2 = jnp.where(right_ok, nre, rre)
        roe2 = jnp.where(right_ok, noe, roe)
        ras2 = jnp.where(right_ok, nas, jnp.where(left_ok, ras + skip,
                                                  ras))
        rae2 = jnp.where(right_ok, nae, rae)
        frs2 = jnp.where(left_ok, nrs, frs)
        fos2 = jnp.where(left_ok, nos, fos)
        fre2 = jnp.where(left_ok, nre, fre)
        foe2 = jnp.where(left_ok, noe, foe)
        fas2 = jnp.where(left_ok, nas, jnp.where(right_ok, fas + skip,
                                                 fas))
        fae2 = jnp.where(left_ok, nae,
                         jnp.where(right_ok, fas + skip + (nae - nas),
                                   fae))
        # keep the companion count in sync after a LEFT step too
        rae2 = jnp.where(left_ok, ras2 + (nae - nas), rae2)
        ml2 = jnp.where(right_ok | left_ok, ml + 1, ml)

        # RIGHT termination: emit (s, s+ml, count(fw)) at index s;
        # count clamps to 0 when the fw side is still the canonical
        # empty interval (its abs form has fas > fae), matching the
        # oracle's interval_count-of-EMPTY == 0
        right_stop = in_right & ~ok
        mem_cnt = jnp.maximum(fae - fas + 1, 0)
        ends = _emit_add(state["ends"], lane_iota, s,
                         jnp.where(right_stop, s + ml, 0))
        counts = _emit_add(state["counts"], lane_iota, s,
                           jnp.where(right_stop, mem_cnt, 0))
        e2 = jnp.where(right_stop, s + ml, e)
        at_end = right_stop & (s + ml >= m)
        phase2 = jnp.where(at_end, AM2_DONE, phase)
        # re-anchor: init at e, ml = 1, left-extend
        reanchor = right_stop & ~at_end
        c_e = char_at(e2)
        ifw, irc = init_pair6(c_e)
        frs2 = jnp.where(reanchor, ifw[0], frs2)
        fos2 = jnp.where(reanchor, ifw[1], fos2)
        fre2 = jnp.where(reanchor, ifw[2], fre2)
        foe2 = jnp.where(reanchor, ifw[3], foe2)
        fas2 = jnp.where(reanchor, ifw[4], fas2)
        fae2 = jnp.where(reanchor, ifw[5], fae2)
        rrs2 = jnp.where(reanchor, irc[0], rrs2)
        ros2 = jnp.where(reanchor, irc[1], ros2)
        rre2 = jnp.where(reanchor, irc[2], rre2)
        roe2 = jnp.where(reanchor, irc[3], roe2)
        ras2 = jnp.where(reanchor, irc[4], ras2)
        rae2 = jnp.where(reanchor, irc[5], rae2)
        ml2 = jnp.where(reanchor, 1, ml2)
        phase2 = jnp.where(reanchor, AM2_LEFT, phase2)

        # LEFT termination: s = e - ml + 1, resolve rc, back to RIGHT
        left_stop = in_left & ~ok
        s2 = jnp.where(left_stop, e - ml + 1, s)
        phase2 = jnp.where(left_stop, AM2_RES, phase2)

        # RES: rc abs -> (run, offset), then RIGHT
        rrs2 = jnp.where(in_res, lo[:, 0], rrs2)
        ros2 = jnp.where(in_res, ras - lo[:, 1], ros2)
        rre2 = jnp.where(in_res, hi[:, 0], rre2)
        roe2 = jnp.where(in_res, rae - hi[:, 1], roe2)
        phase2 = jnp.where(in_res, AM2_RIGHT, phase2)

        new_state = dict(phase=phase2, s=s2, ml=ml2, e=e2,
                         frs=frs2, fos=fos2, fre=fre2, foe=foe2,
                         fas=fas2, fae=fae2,
                         rrs=rrs2, ros=ros2, rre=rre2, roe=roe2,
                         ras=ras2, rae=rae2,
                         ends=ends, counts=counts)
        return new_state, None

    state, _ = jax.lax.scan(tick, state, None, length=ticks)
    return state, jnp.all(state["phase"] == AM2_DONE)


class FusedAllMem2Engine:
    """Batched device all-MEMs (min_mem_length <= 1) on the v2
    one-gather-per-tick records.  Results identical to
    AdvancedEngine.query_all_mems with ftab_k=0."""

    def __init__(self, m2: FusedMem2Index):
        self.m2 = m2

    def query_batch(self, batch: ReadBatch):
        from .fused_mem import _resume_compacted
        from ..io.fastx import left_aligned_slots

        m2 = self.m2
        W, lanes = batch.width, batch.lanes
        amap = m2.alphamap_query.copy()
        amap[ord("#")] = -3
        al = _prep_alc(jnp.asarray(left_aligned_slots(batch, amap)
                                   .astype(np.int8)), 0, False)
        lengths = jnp.asarray(batch.lengths.astype(np.int32))

        def make_state():
            z = jnp.zeros((lanes,), jnp.int32)
            fw, rc = _init_pair6(m2, al[:, 0])
            st = dict(
                phase=jnp.where(lengths > 0, AM2_RIGHT, AM2_DONE
                                ).astype(jnp.int32),
                s=z, ml=jnp.ones((lanes,), jnp.int32), e=z,
                ends=jnp.zeros((lanes, W), jnp.int32),
                counts=jnp.zeros((lanes, W), jnp.int32),
            )
            for i, kk in enumerate(("frs", "fos", "fre", "foe", "fas",
                                    "fae")):
                st[kk] = fw[i].astype(jnp.int32)
            for i, kk in enumerate(("rrs", "ros", "rre", "roe", "ras",
                                    "rae")):
                st[kk] = rc[i].astype(jnp.int32)
            return st

        state = jax.jit(make_state)()
        ticks = 4 * W + 64
        ends, counts = _resume_compacted(
            lambda a, st: _all_mem2_scan(m2, a, ticks, st),
            state, al, lanes, W, AM2_DONE, max_iters=W, label="allMEM2")
        res = []
        for i in range(lanes):
            nz = np.flatnonzero(ends[i])
            res.append([(int(p), int(ends[i][p]), int(counts[i][p]))
                        for p in nz])
        return res
