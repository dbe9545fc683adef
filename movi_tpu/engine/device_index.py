"""Device-resident index layout for the compact query engine.

The reference hides memory latency with per-thread strand interleaving
and software prefetch (read_processor.cpp:641-730).  On the device that
mechanism dissolves: we put tens of thousands of reads in lockstep on a
lane axis and issue *batched* gathers against device-resident tables --
latency is hidden by the memory pipeline across lanes, not by software
round-robin.

Tables (structure-of-arrays; gathers are indexed by current run id):
  n[i]        run length                                  (int32)
  lf_abs[i]   absolute BWT position of the LF image of the run head
              = all_p[id[i]] + offset[i]                  (int64 fused LF)
  all_p[i]    run head positions (+ sentinel n at index r) for the
              searchsorted fast-forward                   (int64)
  thr_full[i, a]   threshold value used by reposition for read char a,
              with the '$' row and separator rows baked in (int32)
  rep_up[a, i] / rep_down[a, i]   destination run when repositioning
              up/down from run i for read char a (scan-free reposition;
              replaces move_structure_query.cpp:188-232)  (int32, r = none)
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..constants import ALPHAMAP_3, SEPARATOR
from ..index.structure import MoveIndex


@dataclass
class DeviceIndex:
    mode: str
    r: int
    length: int
    end_bwt_idx: int
    sigma: int
    n: jax.Array          # int32 [r]
    lf_abs: jax.Array     # int32 [r]
    all_p: jax.Array      # int32 [r+1]
    c: jax.Array          # uint8 [r] (raw stored char: '$' row = 0)
    thr_full: Optional[jax.Array]   # int32 [r, sigma]
    rep_up: jax.Array     # int32 [sigma, r]
    rep_down: jax.Array   # int32 [sigma, r]
    first_runs: jax.Array    # int32 [sigma+1]
    first_offsets: jax.Array
    last_runs: jax.Array
    last_offsets: jax.Array
    alphamap_query: jax.Array  # int32 [256]: byte -> alphabet index, -1 illegal
    # search-variant tables for backward-search interval updates
    # (get_char semantics: the '$' row matches nothing):
    c_search: jax.Array   # int32 [r]: alphabet index, -1 for the '$' row
    ch_up_s: jax.Array    # int32 [sigma, r]: last i' <= i with char a (r none)
    ch_down_s: jax.Array  # int32 [sigma, r]: first i' >= i with char a (r none)

    def hbm_bytes(self) -> int:
        total = 0
        for f in (self.n, self.lf_abs, self.all_p, self.c, self.thr_full,
                  self.rep_up, self.rep_down, self.c_search, self.ch_up_s,
                  self.ch_down_s):
            if f is not None:
                total += f.size * f.dtype.itemsize
        return total


jax.tree_util.register_dataclass(
    DeviceIndex,
    data_fields=["n", "lf_abs", "all_p", "c", "thr_full", "rep_up",
                 "rep_down", "first_runs", "first_offsets", "last_runs",
                 "last_offsets", "alphamap_query", "c_search", "ch_up_s",
                 "ch_down_s"],
    meta_fields=["mode", "r", "length", "end_bwt_idx", "sigma"],
)


def build_thr_full(ix: MoveIndex) -> np.ndarray:
    """Dense per-(row, read-char) threshold table: bakes in ALPHAMAP_3 slot
    selection, the '$' row (end_bwt_idx_thresholds) and separator rows
    (move_structure_query.cpp:513-566)."""
    r, sigma = ix.r, ix.sigma
    thr_full = np.zeros((r, sigma), dtype=np.int32)
    c_eff = ix.c_arr.astype(np.int64)
    sep_index = int(ix.alphamap[SEPARATOR]) if ix.separators else -1
    for a in range(sigma):
        if ix.separators:
            if a == sep_index:
                continue  # never queried (check_alphabet rejects '%')
            slot_of_row = ALPHAMAP_3[np.maximum(c_eff - 1, 0), a - 1]
        else:
            slot_of_row = ALPHAMAP_3[c_eff, a]
        vals = np.where(slot_of_row < 3,
                        np.take_along_axis(
                            ix.thr, np.minimum(slot_of_row, 2)[:, None],
                            axis=1).ravel(),
                        0)
        thr_full[:, a] = vals
    # '$' row
    e = ix.end_bwt_idx
    for a in range(sigma):
        ai = a - 1 if ix.separators else a
        if ix.separators and a == sep_index:
            continue
        if 0 <= ai < len(ix.end_bwt_idx_thresholds):
            thr_full[e, a] = ix.end_bwt_idx_thresholds[ai]
    # separator rows (the '$' row may appear in the map for serialization
    # parity; its thresholds live in end_bwt_idx_thresholds)
    if ix.separators and ix.sep_row_map:
        for row, k in ix.sep_row_map.items():
            if row == ix.end_bwt_idx:
                continue
            for a in range(sigma):
                if a == sep_index:
                    continue
                thr_full[row, a] = ix.sep_thresholds[k][a - 1]
    return thr_full


def build_device_index(ix: MoveIndex, device=None) -> DeviceIndex:
    r, sigma = ix.r, ix.sigma
    # Absolute BWT positions are carried as int32 on device (jax x64 is
    # typically disabled); indexes beyond 2^31 bases need the sharded
    # builder (planned) which keeps positions shard-relative.
    assert ix.length < 2**31, "single-shard index limited to 2^31 bases"

    lf_abs = ix.all_p[ix.id_arr] + ix.offset_arr.astype(np.int64)

    thr_full = build_thr_full(ix) if ix.thr is not None else None

    # reposition tables indexed by the *current* run id, with the
    # reference's edge semantics baked in (reposition_up/down start at
    # idx -1/+1; idx==0 / idx==r-1 yield "none"):
    nu, nd = ix.next_tables()         # '$' row matches alphabet[0]
    nus, nds = ix.next_tables_search()  # '$' row matches nothing
    rep_up = np.full((sigma, r), r, dtype=np.int64)
    rep_down = np.full((sigma, r), r, dtype=np.int64)
    rep_up[:, 1:] = nu[:, :-1]
    rep_down[:, :-1] = nd[:, 1:]
    rep_up = rep_up.astype(np.int32)
    rep_down = rep_down.astype(np.int32)

    c_search = ix.c_arr.astype(np.int32)
    c_search[ix.end_bwt_idx] = -1

    alphamap_query = np.full(256, -1, dtype=np.int32)
    for a, ch in enumerate(ix.alphabet):
        alphamap_query[ch] = a
    if ix.separators:
        alphamap_query[SEPARATOR] = -1  # check_alphabet rejects separators

    put = partial(jax.device_put, device=device) if device else jnp.asarray
    return DeviceIndex(
        mode=ix.mode, r=r, length=ix.length, end_bwt_idx=ix.end_bwt_idx,
        sigma=sigma,
        n=put(ix.n_arr.astype(np.int32)),
        lf_abs=put(lf_abs.astype(np.int32)),
        all_p=put(ix.all_p.astype(np.int32)),
        c=put(ix.c_arr),
        thr_full=put(thr_full) if thr_full is not None else None,
        rep_up=put(rep_up), rep_down=put(rep_down),
        c_search=put(c_search),
        ch_up_s=put(nus.astype(np.int32)), ch_down_s=put(nds.astype(np.int32)),
        first_runs=put(ix.first_runs.astype(np.int32)),
        first_offsets=put(ix.first_offsets.astype(np.int32)),
        last_runs=put(ix.last_runs.astype(np.int32)),
        last_offsets=put(ix.last_offsets.astype(np.int32)),
        alphamap_query=put(alphamap_query),
    )
