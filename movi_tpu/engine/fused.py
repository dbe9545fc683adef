"""Fused single-gather PML engine (8-byte step records).

The compact engine (engine/pml.py) spends ~20 device-memory gathers per
base per lane (row fields, reposition tables, log2(r) searchsorted
steps).  Each is a dependent random access, so gather *count* sets the
step's latency.  This engine gets the entire PML step down to ONE 8-byte
gather:

  1. The index is built with NT-style splitting (`bound_ff=1`,
     index/structure.py:_nt_split, +~3% rows), so a fast-forward is at
     most one step and resolves with a single precomputed cum length.
  2. A per-(run, read-char) record table precomputes EVERYTHING the step
     needs in TWO int32 words.  The match/illegal path (LF) and the
     mismatch path (reposition) are mutually exclusive, so their fields
     overlay:
       w0: main run id m -- the LF destination (match/illegal) or the
           reposition ANCHOR run (mismatch)
       w1: fa (bits 0-11)   lf_offset            | anchor offset
           fb (bits 12-23)  cum1 (n of run m;    | threshold
                            0xFFF = no-ff guard) |
           bump (24), is_match (25), use_lf (26),
           dollar_up (27), dollar_dn (28)
  3. The mismatch path stores only ONE precomputed final state (the
     anchor = reposition-up target after its LF+ff).  The down target
     needs no second run id: consecutive occurrences of a character map
     to ADJACENT positions under LF (LF(k-th c) = C[c] + k), so the
     reposition-down final is always anchor+1 -- (m, fa+1), or (m+1, 0)
     when the anchor is its run's last row (the precomputed `bump` bit).
     The builder asserts this adjacency for every (run, char).
     The one exception is the '$' run, which matches alphabet[0] in
     repositioning (move_structure_query.cpp:277) but whose LF image is
     NOT in alphabet[0]'s C-block: its post-LF state is a single global
     (run, offset) constant P$, selected by the dollar_up/dollar_dn bits.
  4. The scan body is: one gather, ~20 elementwise ops, no
     data-dependent control flow.  Bit-exact against ScalarEngine (tests/test_fused.py).

Memory: (sigma+1) * 8 B per row (40 B/row for DNA) vs 8 B/row for the
reference's packed regular-thresholds layout (move_row_configs.hpp:34-51)
-- a trade of device-memory capacity for latency-critical access
count.  A human-pangenome-scale index (r ~= 1e8) is 4 GB: resident on
one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List

import numpy as np

import jax
import jax.numpy as jnp

from .device_index import build_thr_full
from ..index.structure import MoveIndex
from ..io.fastx import ReadBatch

# w1 bit layout
FA_MASK = 0xFFF          # bits 0-11
FB_SHIFT = 12            # bits 12-23
FB_MASK = 0xFFF
BIT_BUMP = 24
BIT_MATCH = 25
BIT_USE_LF = 26
BIT_DOLLAR_UP = 27
BIT_DOLLAR_DN = 28
CUM_GUARD = 0xFFF        # fb value meaning "no fast forward" (id == r-1)
# fields are 12-bit; run lengths (and with them offsets, thresholds and
# the lf_off+offset sum vs the guard) must stay under this cap
MAX_FIELD_N = 2047


@dataclass
class FusedIndex:
    r: int
    sigma: int
    records: jax.Array      # int32 [r*(sigma+1), 2]
    start_idx: int          # initial run (r-1)
    start_offset: int       # initial offset (n[r-1]-1)
    p_dollar: tuple         # (run, offset) after repositioning onto the
                            # '$' run + LF+ff (static per index)
    alphamap_query: np.ndarray  # host-side: byte -> slot (sigma = illegal)


jax.tree_util.register_dataclass(
    FusedIndex,
    # alphamap_query is host-side only but must be a data field (ndarrays
    # are not hashable as pytree aux data)
    data_fields=["records", "alphamap_query"],
    meta_fields=["r", "sigma", "start_idx", "start_offset", "p_dollar"],
)


def build_fused_index(ix: MoveIndex) -> FusedIndex:
    """Precompute the per-(run, char) step records.

    Requires an index built with bound_ff=1 (NT splitting) and thresholds.
    """
    assert ix.thr is not None, "fused engine requires a thresholds mode"
    r, sigma = ix.r, ix.sigma
    n64 = ix.n_arr.astype(np.int64)
    all_p = ix.all_p
    lf_abs = all_p[ix.id_arr] + ix.offset_arr.astype(np.int64)

    # verify the bound_ff=1 invariant
    e = lf_abs + n64 - 1
    id_end = np.searchsorted(all_p[:-1], e, side="right") - 1
    assert int(np.max(id_end - ix.id_arr)) <= 1, (
        "fused engine requires an index built with bound_ff=1")
    # 12-bit field invariants (reference `large`/`split` indexes allow
    # runs up to 65535; they must be re-split before fusing)
    assert int(n64.max()) <= MAX_FIELD_N, (
        f"fused records pack 12-bit fields; max run length {int(n64.max())} "
        f"exceeds {MAX_FIELD_N} -- rebuild the index with NT splitting")
    assert int(ix.offset_arr.max()) <= MAX_FIELD_N

    thr_full = build_thr_full(ix)          # [r, sigma]
    assert int(thr_full.max()) <= MAX_FIELD_N
    nu, nd = ix.next_tables()              # query tables ('$' row = slot 0)

    def resolve(abs_pos):
        run = np.searchsorted(all_p[:-1], abs_pos, side="right") - 1
        return run, abs_pos - all_p[run]

    ebw = ix.end_bwt_idx
    assert int(n64[ebw]) == 1, "the '$' run must have length 1"
    # P$: reposition onto the '$' run (up lands at offset n-1 = 0, down at
    # offset 0 -- identical), then LF+ff
    pd_run, pd_off = resolve(int(lf_abs[ebw]))
    p_dollar = (int(pd_run), int(pd_off))

    slots = sigma + 1
    w0 = np.zeros((r, slots), dtype=np.int64)
    w1 = np.zeros((r, slots), dtype=np.int64)

    lf_off = ix.offset_arr.astype(np.int64)
    # LF_move only fast-forwards while idx < r-1 (move_structure.cpp:69):
    cum1 = np.where(ix.id_arr < r - 1, n64[ix.id_arr], CUM_GUARD)
    f_id = ix.id_arr.astype(np.int64)
    w1_lf = lf_off | (cum1 << FB_SHIFT)

    from ..constants import SEPARATOR
    sep_index = int(ix.alphamap[SEPARATOR]) if ix.separators else -1

    for a in range(sigma):
        if a == sep_index:
            # '%' slot: reads never map here (check_alphabet rejects
            # separators); encode as plain LF like the illegal slot
            w0[:, a] = f_id
            w1[:, a] = w1_lf | (1 << BIT_USE_LF)
            continue
        # reposition targets from the current run (edge semantics of
        # reposition_up/down: start scanning at idx -/+ 1)
        up = np.full(r, r, dtype=np.int64)
        dn = np.full(r, r, dtype=np.int64)
        up[1:] = nu[a, :-1]
        dn[:-1] = nd[a, 1:]
        up_dollar = up == ebw
        dn_dollar = dn == ebw
        have_up = (up < r) & ~up_dollar
        have_dn = (dn < r) & ~dn_dollar
        up_c = np.where(have_up, up, 0)
        dn_c = np.where(have_dn, dn, 0)
        # exact final state after reposition + LF + ff, per side
        up_abs = all_p[ix.id_arr[up_c]] + ix.offset_arr[up_c] + n64[up_c] - 1
        dn_abs = all_p[ix.id_arr[dn_c]] + ix.offset_arr[dn_c]
        # structural adjacency: on MISMATCH rows (the only rows whose
        # reposition fields are ever read) no run of `a` lies between the
        # two neighbors, so their LF images are consecutive occurrences
        # of `a`, hence consecutive BWT positions.  The whole 8-byte
        # encoding rests on this, so verify it for every run.  (On match
        # rows the run itself sits between its neighbors and the claim is
        # void -- those slots hold the LF fields instead.)
        is_match = (ix.c_arr.astype(np.int64) == a)
        both = have_up & have_dn & ~is_match
        assert np.all(dn_abs[both] == up_abs[both] + 1), (
            "LF adjacency violated -- index is corrupt")
        up_run, up_off = resolve(up_abs)

        # anchor: the up final when a real up exists; otherwise dn-1 (so
        # the derived down target is still exact; the up side is then
        # either P$ via dollar_up, or unreachable because thr == 0)
        dn_run, dn_off = resolve(dn_abs)
        roll = (dn_off == 0).astype(np.int64)
        alt_m = dn_run - roll
        alt_fa = np.maximum(dn_off - 1, 0)
        m = np.where(have_up, up_run, alt_m)
        fa = np.where(have_up, up_off, alt_fa)
        bump = np.where(have_up,
                        (up_off + 1 == n64[np.minimum(up_run, r - 1)]),
                        roll).astype(np.int64)
        # when the up side is unreachable-by-threshold (no up run at all),
        # reposition must always go down; reference thresholds guarantee
        # thr == 0 there (compute_thresholds, move_structure_build.cpp)
        no_up = ~have_up & ~up_dollar & ~is_match
        assert np.all(thr_full[no_up, a] == 0), \
            "threshold nonzero for a run with no up-neighbor"
        no_dn = ~have_dn & ~dn_dollar & ~is_match
        assert np.all(thr_full[no_dn, a].astype(np.int64) >= n64[no_dn]), \
            "threshold allows down for a run with no down-neighbor"

        w0[:, a] = np.where(is_match, f_id, m)
        w1_mis = (fa | (thr_full[:, a].astype(np.int64) << FB_SHIFT)
                  | (bump << BIT_BUMP)
                  | (up_dollar.astype(np.int64) << BIT_DOLLAR_UP)
                  | (dn_dollar.astype(np.int64) << BIT_DOLLAR_DN))
        w1_mat = w1_lf | (1 << BIT_MATCH) | (1 << BIT_USE_LF)
        w1[:, a] = np.where(is_match, w1_mat, w1_mis)

    # illegal slot: plain LF, no match
    w0[:, sigma] = f_id
    w1[:, sigma] = w1_lf | (1 << BIT_USE_LF)

    alphamap_query = np.full(256, sigma, dtype=np.int32)
    for a, ch in enumerate(ix.alphabet):
        alphamap_query[ch] = a
    if ix.separators:
        alphamap_query[SEPARATOR] = sigma

    rec = np.stack([w0.reshape(-1), w1.reshape(-1)], axis=1)
    return FusedIndex(
        r=r, sigma=sigma,
        records=jnp.asarray(rec.astype(np.int32)),
        start_idx=r - 1,
        start_offset=int(ix.n_arr[r - 1]) - 1,
        p_dollar=p_dollar,
        alphamap_query=alphamap_query,
    )


_FUSED_FMT = 2  # on-disk cache format (bumped when the record layout changes)


def save_fused_index(fi: FusedIndex, path: str):
    """Persist the precomputed step records so query startup skips the
    O(r*sigma) host rebuild (~17 s at 4.3 M runs) -- the analogue of the
    reference shipping its packed rlbwt inside index.movi."""
    np.savez(path, records=np.asarray(fi.records),
             meta=np.array([fi.r, fi.sigma, fi.start_idx, fi.start_offset,
                            fi.p_dollar[0], fi.p_dollar[1], _FUSED_FMT],
                           dtype=np.int64),
             alphamap_query=fi.alphamap_query)


def load_fused_index(path: str) -> FusedIndex:
    z = np.load(path)
    meta = [int(x) for x in z["meta"]]
    if len(meta) < 7 or meta[6] != _FUSED_FMT:
        raise ValueError(
            f"{path}: stale fused-record cache (format {meta[6] if len(meta) > 6 else 1}, "
            f"need {_FUSED_FMT}); rebuild with `build --fused-cache`")
    r, sigma, start_idx, start_offset, pd_run, pd_off = meta[:6]
    return FusedIndex(r=r, sigma=sigma,
                      records=jnp.asarray(z["records"]),
                      start_idx=start_idx, start_offset=start_offset,
                      p_dollar=(pd_run, pd_off),
                      alphamap_query=z["alphamap_query"])


def fused_step_math(rec: jax.Array, state, p_dollar):
    """The PML step math on an already-gathered record [lanes, 2].
    Shared by the single-chip gather step and the model-sharded psum step
    (parallel/sharded_index.py)."""
    idx, offset, ml = state
    m = rec[:, 0]
    w1 = rec[:, 1]
    fa = w1 & FA_MASK
    fb = (w1 >> FB_SHIFT) & FB_MASK
    is_match = (w1 >> BIT_MATCH) & 1
    use_lf = (w1 >> BIT_USE_LF) & 1

    # LF path (case 1 / illegal): bounded fast-forward via cum1 (= fb)
    off0 = fa + offset
    ff = (off0 >= fb).astype(jnp.int32)
    c1_run = m + ff
    c1_off = off0 - ff * fb

    # reposition path (case 2): offset >= threshold (= fb) goes down;
    # targets derive from the anchor (m, fa) or the global P$ constant
    down = offset >= fb
    bump = (w1 >> BIT_BUMP) & 1
    d_up = (w1 >> BIT_DOLLAR_UP) & 1
    d_dn = (w1 >> BIT_DOLLAR_DN) & 1
    pd_run, pd_off = p_dollar
    up_run = jnp.where(d_up == 1, pd_run, m)
    up_off = jnp.where(d_up == 1, pd_off, fa)
    dn_run = jnp.where(d_dn == 1, pd_run, m + bump)
    dn_off = jnp.where(d_dn == 1, pd_off, jnp.where(bump == 1, 0, fa + 1))
    c2_run = jnp.where(down, dn_run, up_run)
    c2_off = jnp.where(down, dn_off, up_off)

    lf_path = use_lf == 1
    new_idx = jnp.where(lf_path, c1_run, c2_run)
    new_off = jnp.where(lf_path, c1_off, c2_off)
    new_ml = jnp.where(is_match == 1, ml + 1, 0)
    return (new_idx, new_off, new_ml), new_ml


def fused_lf_math(rec: jax.Array, offset: jax.Array):
    """Plain LF + bounded ff from a gathered record's LF fields (valid on
    match and illegal slots).  Returns (run, offset)."""
    m = rec[:, 0]
    w1 = rec[:, 1]
    fa = w1 & FA_MASK
    fb = (w1 >> FB_SHIFT) & FB_MASK
    off0 = fa + offset
    ff = (off0 >= fb).astype(jnp.int32)
    return m + ff, off0 - ff * fb


def fused_pml_step(records: jax.Array, slots: int, p_dollar, state, a_eff):
    """One PML base step: single 8-byte gather + elementwise math."""
    idx, _, _ = state
    rec = jnp.take(records, idx * slots + a_eff, axis=0)  # [lanes, 2]
    return fused_step_math(rec, state, p_dollar)


@partial(jax.jit, donate_argnums=(1,))
def _fused_pml_scan(fi: FusedIndex, alphas_t: jax.Array):
    """alphas_t: [W, lanes], values in [0, sigma] (sigma = illegal).
    Returns ml [W, lanes].

    alphas arrive as uint8 to quarter the host->device transfer, and are
    widened ONCE on device so the scan slices int32 rows."""
    lanes = alphas_t.shape[1]
    slots = fi.sigma + 1
    alphas_t = alphas_t.astype(jnp.int32)
    idx0 = jnp.full((lanes,), fi.start_idx, dtype=jnp.int32)
    off0 = jnp.full((lanes,), fi.start_offset, dtype=jnp.int32)
    ml0 = jnp.zeros((lanes,), dtype=jnp.int32)

    def step(state, a):
        return fused_pml_step(fi.records, slots, fi.p_dollar, state, a)

    _, ml = jax.lax.scan(step, (idx0, off0, ml0), alphas_t)
    return ml


@jax.jit
def _fused_pml_scan_carry(fi: FusedIndex, alphas_t: jax.Array, state):
    """Chunk of the PML scan with an explicit carried state, for long
    reads (nanopore, up to ~1 Mb): the per-read LF chain is inherently
    serial, so long sequences are handled by chunking the scan with
    carried (idx, offset, match_len) -- SURVEY.md section 5 -- instead of
    compiling one scan per (huge) read-length bucket."""
    slots = fi.sigma + 1
    alphas_t = alphas_t.astype(jnp.int32)

    def step(st, a):
        return fused_pml_step(fi.records, slots, fi.p_dollar, st, a)

    state, ml = jax.lax.scan(step, state, alphas_t)
    return state, ml


class FusedPMLEngine:
    # reads longer than this scan in fixed-size carried chunks (one
    # compile total instead of one per width bucket)
    CHUNK = 2048

    def __init__(self, fi: FusedIndex):
        self.fi = fi

    def query_batch_device(self, batch: ReadBatch) -> jax.Array:
        seqs_rev = batch.seqs[:, ::-1]
        alphas = self.fi.alphamap_query[seqs_rev]  # [lanes, W]
        # ship as uint8 (slot values <= sigma); widened on device
        alphas_t = jnp.asarray(np.ascontiguousarray(alphas.T).astype(np.uint8))
        W, lanes = alphas_t.shape
        if W <= self.CHUNK:
            return _fused_pml_scan(self.fi, alphas_t)
        fi = self.fi
        C = self.CHUNK
        pad = (-W) % C
        if pad:
            # pad the scan TAIL with the illegal slot: reads are
            # right-aligned so columns beyond W - 1 are past every
            # read's end and their emissions are discarded
            alphas_t = jnp.concatenate(
                [alphas_t, jnp.full((pad, lanes), fi.sigma, jnp.uint8)])
        state = (jnp.full((lanes,), fi.start_idx, jnp.int32),
                 jnp.full((lanes,), fi.start_offset, jnp.int32),
                 jnp.zeros((lanes,), jnp.int32))
        mls = []
        for c0 in range(0, W + pad, C):
            state, ml = _fused_pml_scan_carry(
                self.fi, jax.lax.slice_in_dim(alphas_t, c0, c0 + C), state)
            mls.append(ml)
        return jnp.concatenate(mls)[:W]

    def query_batch(self, batch: ReadBatch) -> List[List[int]]:
        ml = np.asarray(self.query_batch_device(batch))
        out = []
        for lane in range(batch.lanes):
            L = int(batch.lengths[lane])
            out.append(ml[:L, lane].tolist())
        return out
