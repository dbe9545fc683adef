"""Fused backward-search engines: count and ZML at 2 gathers per base.

The compact engines (engine/search.py) spend ~6+ gathers per step
(char checks, nearest-run tables, two searchsorted LF resolutions).
Random gathers cost per row (engine/fused.py), so both interval ends
fold into one 16-byte record gather each:

  rec_down[i, a] (for the interval start): the first run >= i whose
      get_char() == a, together with that run's LF data and the bounded
      fast-forward cum (requires a bound_ff=1 index):
        g0: dest run
        g1: id (LF destination base run of dest)
        g2: cum1 | lf_off<<16
        g3: n[dest]
  rec_up[i, a]: same for the last run <= i.

A step = gather rec_down at (run_start, a), rec_up at (run_end, a),
then pure elementwise math (update_interval + 2x LF_move + fast_forward,
move_structure_search.cpp:295-333).  Bit-exact vs ScalarEngine.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..index.structure import MoveIndex
from ..io.fastx import ReadBatch

_GUARD = 0xFFFF


@dataclass
class FusedSearchIndex:
    r: int
    sigma: int
    ftab_k: int
    # both direction tables concatenated: rows [0, sigma*r) are the
    # "down" records (interval start), rows [sigma*r, 2*sigma*r) the
    # "up" records (interval end).  One table so a step's two record
    # fetches issue as ONE gather of 2*lanes indices instead of two.
    rec_all: jax.Array    # int32 [2*r*sigma, 4]
    # init_rec[a+1] = (first_run, first_offset, last_run, last_offset):
    # the four initialize_backward_search lookups as one gather
    init_rec: jax.Array   # int32 [sigma+2, 4]
    first_runs: jax.Array
    first_offsets: jax.Array
    last_runs: jax.Array
    last_offsets: jax.Array
    all_p: jax.Array      # int32 [r+1] (for final interval counts)
    alphamap_query: np.ndarray


jax.tree_util.register_dataclass(
    FusedSearchIndex,
    data_fields=["rec_all", "init_rec", "first_runs", "first_offsets",
                 "last_runs", "last_offsets", "all_p", "alphamap_query"],
    meta_fields=["r", "sigma", "ftab_k"],
)


def build_fused_search_index(ix: MoveIndex,
                             ftab_k: int = 0) -> FusedSearchIndex:
    """With ftab_k > 1, 4^fk anchor rows (the fk-mer's backward-search
    interval, canonical-empty when absent) are APPENDED to rec_all at
    row offset 2*sigma*r, so the membership machine's anchor/probe
    inits ride the same per-tick gather (engine/fused_kmer.py)."""
    r, sigma = ix.r, ix.sigma
    n64 = ix.n_arr.astype(np.int64)
    lf_abs = ix.all_p[ix.id_arr] + ix.offset_arr.astype(np.int64)
    e = lf_abs + n64 - 1
    id_end = np.searchsorted(ix.all_p[:-1], e, side="right") - 1
    assert int(np.max(id_end - ix.id_arr)) <= 1, (
        "fused search requires an index built with bound_ff=1")

    nus, nds = ix.next_tables_search()  # inclusive; '$' matches nothing

    def records(dest_tab):
        rec = np.zeros((sigma, r, 4), dtype=np.int64)
        for a in range(sigma):
            dest = dest_tab[a].astype(np.int64)
            ok = dest < r
            d = np.where(ok, dest, 0)
            idd = ix.id_arr[d]
            cum1 = np.where(idd < r - 1, n64[idd], _GUARD)
            rec[a, :, 0] = np.where(ok, dest, r)
            rec[a, :, 1] = idd
            rec[a, :, 2] = cum1 | (ix.offset_arr[d].astype(np.int64) << 16)
            rec[a, :, 3] = n64[d]
        return rec.reshape(sigma * r, 4).astype(np.int32)

    alphamap_query = np.full(256, -1, dtype=np.int32)
    for a, ch in enumerate(ix.alphabet):
        alphamap_query[ch] = a
    from ..constants import SEPARATOR
    if ix.separators:
        alphamap_query[SEPARATOR] = -1

    init_rec = np.stack([ix.first_runs, ix.first_offsets,
                         ix.last_runs, ix.last_offsets],
                        axis=1).astype(np.int32)
    parts = [records(nds), records(nus)]
    if ftab_k > 1:
        from .fused_mem2 import build_ftab_rows

        fr = build_ftab_rows(ix, ftab_k, rc_merge=False)
        valid = fr[:, 7] == 1
        frow = np.where(valid[:, None], fr[:, 0:4],
                        np.array([[1, 0, 0, 0]], np.int32))
        parts.append(frow.astype(np.int32))
    return FusedSearchIndex(
        r=r, sigma=sigma, ftab_k=ftab_k,
        rec_all=jnp.asarray(np.concatenate(parts)),
        init_rec=jnp.asarray(init_rec),
        first_runs=jnp.asarray(ix.first_runs.astype(np.int32)),
        first_offsets=jnp.asarray(ix.first_offsets.astype(np.int32)),
        last_runs=jnp.asarray(ix.last_runs.astype(np.int32)),
        last_offsets=jnp.asarray(ix.last_offsets.astype(np.int32)),
        all_p=jnp.asarray(ix.all_p.astype(np.int32)),
        alphamap_query=alphamap_query,
    )


def _lf_from_rec(rec, offset):
    """LF + bounded ff from a search record and an in-dest offset."""
    f2 = rec[:, 2]
    off0 = (f2 >> 16) + offset
    cum1 = f2 & 0xFFFF
    ff = (off0 >= cum1).astype(jnp.int32)
    return rec[:, 1] + ff, off0 - ff * cum1


def fused_bs_step(si: FusedSearchIndex, rs, os_, re, oe, a):
    """backward_search_step: returns (rs', os', re', oe', empty).
    Both record fetches go out as one gather of 2*lanes indices into the
    concatenated table (see FusedSearchIndex.rec_all)."""
    r = si.r
    a_s = jnp.maximum(a, 0)
    lanes = rs.shape[0]
    keys = jnp.concatenate([
        a_s * r + jnp.minimum(rs, r - 1),
        si.sigma * r + a_s * r + jnp.minimum(re, r - 1)])
    both = jnp.take(si.rec_all, keys, axis=0)
    rd, ru = both[:lanes], both[lanes:]
    drs = rd[:, 0]
    dre = ru[:, 0]
    empty = (a < 0) | (drs >= r) | (drs > re)
    os1 = jnp.where(drs != rs, 0, os_)
    oe1 = jnp.where(dre != re, ru[:, 3] - 1, oe)
    nrs, nos = _lf_from_rec(rd, os1)
    nre, noe = _lf_from_rec(ru, oe1)
    return nrs, nos, nre, noe, empty


def _init_interval(si: FusedSearchIndex, a):
    """initialize_backward_search as ONE gather of the packed
    (first_run, first_offset, last_run, last_offset) record.  Best for
    the tick machines (kmer/MEM) where init competes with record
    gathers; the per-step ZML path uses the one-hot variant below
    (no second gather per step)."""
    rec = jnp.take(si.init_rec, jnp.maximum(a, 0) + 1, axis=0)
    return rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3]


def _onehot_rows(table, idx):
    """Row-select from a TINY table as a one-hot compare-and-sum:
    elementwise work that fuses next to a step's record gather instead
    of issuing a second gather."""
    n = table.shape[0]
    oh = idx[:, None] == jnp.arange(n, dtype=idx.dtype)[None, :]
    return jnp.sum(jnp.where(oh[:, :, None], table[None, :, :], 0),
                   axis=1)


def _init_interval_oh(si: FusedSearchIndex, a):
    """initialize_backward_search inside a per-step scan body: one-hot
    row select so the init does not compete with the record gather."""
    rec = _onehot_rows(si.init_rec, jnp.maximum(a, 0) + 1)
    return rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3]


# One-hot vs per-lane gather for tick-machine char fetches/emits: the
# one-hot costs O(lanes*W) elementwise work per tick, the gather one
# dependent load.  512 is an untuned default (no GPU sweep yet); the
# width is overridable for that sweep (MOVI_TPU_ONEHOT_W).
import os as _os

_CHAR_ONEHOT_MAX_W = int(_os.environ.get("MOVI_TPU_ONEHOT_W", 512))


def _char_select(alphas, lane_iota, pos):
    """Per-lane read-character fetch inside a tick machine:
    alphas[l, clip(pos[l])].  For typical read widths a one-hot
    compare-and-sum (elementwise work fused next to the tick's record
    gather); very long reads fall back to the per-lane gather, whose
    cost does not grow with W."""
    W = alphas.shape[1]
    p = jnp.clip(pos, 0, W - 1)
    if W <= _CHAR_ONEHOT_MAX_W:
        oh = p[:, None] == jnp.arange(W, dtype=p.dtype)[None, :]
        return jnp.sum(jnp.where(oh, alphas, 0), axis=1)
    return alphas[lane_iota, p]


def _emit_add(buf, lane_iota, pos, val):
    """buf.at[lane, clip(pos[lane])].add(val[lane]) inside a tick
    machine: for typical widths emitted as a one-hot dense add instead
    of a per-tick scatter; very long reads keep the scatter."""
    W = buf.shape[1]
    p = jnp.clip(pos, 0, W - 1)
    if W <= _CHAR_ONEHOT_MAX_W:
        oh = jnp.arange(W, dtype=p.dtype)[None, :] == p[:, None]
        return buf + jnp.where(oh, val[:, None], 0)
    return buf.at[lane_iota, p].add(val)


# current interval keys and the keys holding the last non-empty interval
# (the reference reports the interval BEFORE the failing extension,
# move_structure_search.cpp:340-352)
_CUR_KEYS = ("rs", "os", "re", "oe")
_PREV_KEYS = ("prs", "pos_", "pre", "poe")


def _count_body(si: FusedSearchIndex):
    def body(state, a):
        alive = ~state["done"]
        stepped = fused_bs_step(
            si, state["rs"], state["os"], state["re"], state["oe"], a)
        empty = stepped[-1]
        ok = alive & ~empty
        new = dict(state)
        for cur, prev, v in zip(_CUR_KEYS, _PREV_KEYS, stepped[:4]):
            new[cur] = jnp.where(ok, v, state[cur])
            new[prev] = jnp.where(ok, v, state[prev])
        new["matched"] = state["matched"] + ok.astype(jnp.int32)
        new["done"] = state["done"] | (alive & empty)
        return new, None
    return body


@jax.jit
def _count_init(si: FusedSearchIndex, a0):
    a0 = a0.astype(jnp.int32)
    legal0 = a0 >= 0
    rs, os_, re, oe = _init_interval(si, a0)
    return dict(rs=rs, os=os_, re=re, oe=oe, done=~legal0,
                matched=jnp.where(legal0, 1, 0).astype(jnp.int32),
                prs=rs, pos_=os_, pre=re, poe=oe)


@jax.jit
def _count_carry(si: FusedSearchIndex, alphas_t: jax.Array, state):
    state, _ = jax.lax.scan(_count_body(si), state,
                            alphas_t.astype(jnp.int32))
    return state


SCAN_CHUNK = 2048


def fused_count_scan(si: FusedSearchIndex, alphas_t: jax.Array):
    """Count query (query_backward_search).  alphas_t: [W, lanes],
    -1 = illegal, -2 = beyond read.  Returns (matched, count).
    int8 xs are widened once on device (per-step slicing of sub-int32
    xs is ~3x slower; see engine/fused.py); widths beyond SCAN_CHUNK
    scan in carried chunks (long-read path)."""
    W = alphas_t.shape[0]
    state = _count_init(si, alphas_t[0])
    for c0 in range(1, W, SCAN_CHUNK):
        state = _count_carry(
            si, jax.lax.slice_in_dim(alphas_t, c0,
                                     min(c0 + SCAN_CHUNK, W)), state)
    abs_s = jnp.take(si.all_p, state["prs"], axis=0) + state["pos_"]
    abs_e = jnp.take(si.all_p, state["pre"], axis=0) + state["poe"]
    started = state["matched"] > 0
    return state["matched"], jnp.where(started, abs_e - abs_s + 1, 0)


@jax.jit
def _zml_init(si: FusedSearchIndex, a0):
    a0 = a0.astype(jnp.int32)
    legal0 = a0 >= 0
    rs, os_, re, oe = _init_interval(si, a0)
    return dict(rs=rs, os=os_, re=re, oe=oe, have=legal0,
                ml=jnp.zeros(a0.shape, jnp.int32))


@jax.jit
def _zml_carry(si: FusedSearchIndex, alphas_t: jax.Array, state):
    def body(state, a_next):
        emit = jnp.where(state["have"], state["ml"], 0)
        nrs, nos, nre, noe, empty = fused_bs_step(
            si, state["rs"], state["os"], state["re"], state["oe"], a_next)
        ext_ok = state["have"] & ~empty
        irs, ios, ire, ioe = _init_interval_oh(si, a_next)
        legal = a_next >= 0
        new = dict(
            rs=jnp.where(ext_ok, nrs, irs),
            os=jnp.where(ext_ok, nos, ios),
            re=jnp.where(ext_ok, nre, ire),
            oe=jnp.where(ext_ok, noe, ioe),
            have=ext_ok | (~ext_ok & legal),
            ml=jnp.where(ext_ok, state["ml"] + 1, 0),
        )
        return new, emit

    return jax.lax.scan(body, state, alphas_t.astype(jnp.int32))


def fused_zml_scan(si: FusedSearchIndex, alphas_t: jax.Array):
    """ZML (query_zml recurrence, see engine/search.py); widths beyond
    SCAN_CHUNK scan in carried chunks (long-read path)."""
    W = alphas_t.shape[0]
    state = _zml_init(si, alphas_t[0])
    emit_chunks = []
    for c0 in range(1, W, SCAN_CHUNK):
        state, emits = _zml_carry(
            si, jax.lax.slice_in_dim(alphas_t, c0,
                                     min(c0 + SCAN_CHUNK, W)), state)
        emit_chunks.append(emits)
    last = jnp.where(state["have"], state["ml"], 0)
    return jnp.concatenate(emit_chunks + [last[None, :]], axis=0)


class FusedCountEngine:
    def __init__(self, si: FusedSearchIndex):
        self.si = si

    def query_batch(self, batch: ReadBatch) -> List[Tuple[int, int]]:
        seqs_rev = batch.seqs[:, ::-1]
        alphas = self.si.alphamap_query[seqs_rev].astype(np.int32)
        W = batch.width
        t_idx = np.arange(W)[None, :]
        alphas = np.where(t_idx >= batch.lengths[:, None], -2, alphas)
        # ship as int8 (values in [-2, sigma)); widened on device
        matched, count = fused_count_scan(
            self.si, jnp.asarray(np.ascontiguousarray(alphas.T)
                                 .astype(np.int8)))
        matched = np.asarray(matched)
        count = np.asarray(count)
        return [(int(batch.lengths[i]) - int(matched[i]), int(count[i]))
                for i in range(batch.lanes)]


class FusedZMLEngine:
    def __init__(self, si: FusedSearchIndex):
        self.si = si

    def query_batch(self, batch: ReadBatch) -> List[List[int]]:
        seqs_rev = batch.seqs[:, ::-1]
        alphas = self.si.alphamap_query[seqs_rev].astype(np.int32)
        ml = np.asarray(fused_zml_scan(
            self.si, jnp.asarray(np.ascontiguousarray(alphas.T)
                                 .astype(np.int8))))
        return [ml[: int(batch.lengths[i]), i].tolist()
                for i in range(batch.lanes)]
