"""Paired-base PML engine: ONE 16-byte gather per TWO bases.

The fused engine (engine/fused.py) issues one dependent 8-byte record
gather per base.  A random gather costs per ROW (a 32 B memory sector
holds a 16 B record as well as an 8 B one), so the way to fewer
dependent accesses is fewer gathers per base.  This engine precomputes
the TWO-STEP transition for every (run, char1, char2) and packs it into
one 128-bit record, halving gathers and scan steps per base.

Why two steps compose into 128 bits: a single PML step branches on ONE
offset comparison (LF fast-forward `fa+x >= fb`, or reposition
`x >= threshold`), and each branch is either affine in the offset with
slope 1 (the LF path) or a constant state (the reposition path, thanks
to the LF-adjacency anchor trick of engine/fused.py).  Composing two
steps therefore yields: one step-1 breakpoint T1 selecting a branch,
and per branch a second comparison of the SAME x against a precomposed
constant -- the step-2 decode collapses to the standard one-step decode
with precomposed fields.  Per (run, a1, a2):

  header     T1 (13-bit biased) + match1 bit
  per branch a 54-bit descriptor, kind in {LF2, MIS2, CONST}:
    LF2   (both steps LF-like): off0 = B + x; ff = off0 >= C;
          next = (A + ff, off0 - ff*C)        B = fa1(+/-fb1)+fa2, C = cum
    MIS2  (step 2 repositions): down = x >= B (B = thr2 - c1, clamped);
          anchor decode exactly like the one-step mismatch path
          (A = anchor run, C = anchor offset, flags = bump/dollar bits)
    CONST (step 1 repositioned, so step 2 resolves at build time):
          next = (A, C)

Packing (4 int32 words; run ids are 25-bit -- the engine asserts
r < 2^25 = 3.4e7, which covers the layout's true HBM envelope:
400 B/run * 3.4e7 = 13 GB on a 16 GB chip.  The reference's regular
mode addresses r up to 2^32, move_row_configs.hpp:34-51; past 2^25 the
one-step fused engine takes over):

  w0: T1+4096 (bits 0-12) | match1 (13) | A_lo>>16 (14-22) | A_hi>>16 (23-31)
  w1: B_lo+4096 (0-12) | C_lo (13-24) | kind_lo (25-26) | flags_lo (27-29)
  w2: same fields for the hi branch
  w3: A_lo & 0xFFFF (0-15) | A_hi & 0xFFFF (16-31)

Memory: (sigma+1)^2 * 16 B per run (400 B/run for DNA) -- 10x the fused
engine.  This is the SPEED layout; engine/fused.py remains the capacity
layout (engine selection is automatic, see engine/select.py).  Bit-exact
against ScalarEngine (tests/test_fused2.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

import jax
import jax.numpy as jnp

from .fused import (BIT_BUMP, BIT_DOLLAR_DN, BIT_DOLLAR_UP, BIT_MATCH,
                    BIT_USE_LF, FA_MASK, FB_MASK, FB_SHIFT, FusedIndex)
from ..io.fastx import ReadBatch

KIND_LF2 = 0
KIND_MIS2 = 1
KIND_CONST = 2

_BIAS = 4096          # 13-bit biased signed fields (T1, B)
MAX_RUNS = 1 << 25    # A fields are 25-bit (16 low in w3 + 9 high in w0)


@dataclass
class Fused2Index:
    r: int
    sigma: int
    records: jax.Array          # int32 [r*(sigma+1)^2, 4]
    start_idx: int
    start_offset: int
    p_dollar: tuple
    alphamap_query: np.ndarray


jax.tree_util.register_dataclass(
    Fused2Index, data_fields=["records", "alphamap_query"],
    meta_fields=["r", "sigma", "start_idx", "start_offset", "p_dollar"])


def _decode1(wa, wb):
    """One-step record words -> field dict (engine/fused.py packing)."""
    return dict(
        m=wa, fa=wb & FA_MASK, fb=(wb >> FB_SHIFT) & FB_MASK,
        bump=(wb >> BIT_BUMP) & 1, match=(wb >> BIT_MATCH) & 1,
        use_lf=(wb >> BIT_USE_LF) & 1, d_up=(wb >> BIT_DOLLAR_UP) & 1,
        d_dn=(wb >> BIT_DOLLAR_DN) & 1)


def _compose_chunk(out, records1, cids, c0, r: int, slots: int,
                   p_dollar, ch: int):
    """Compose the two-step records for runs [c0, c0+ch) and write them
    into `out` (donated) at row c0*slots^2.  The composition is gathers
    + elementwise selects ON DEVICE: it runs in seconds where a host
    numpy loop took ~17 min at r = 5M, and the table never crosses the
    host-device link.  Chunking + donation keep the peak at
    table + O(chunk) instead of 2x table, which is what lets the layout
    reach its advertised HBM envelope (a 2^25-run compose would OOM a
    16 GB chip at 2x).  Returns (out, b_min, b_max) -- the caller
    asserts the B-field bounds host-side.

    With `cids` (int32 [r] clamped color ids), emits 8-word records
    whose words 4-6 carry the color ids of both steps' candidate
    destinations (word 4: step-1 {lo,hi} pair; words 5/6: per-branch
    step-2 {a,b} pairs selected by ff/down) -- the paired Movi Color
    layout (word 7 pads to a power-of-two row)."""
    pd_run, pd_off = p_dollar
    chunk = jax.lax.dynamic_slice_in_dim(
        records1, c0 * slots, ch * slots).reshape(ch, slots, 2)
    f1 = _decode1(chunk[:, :, 0], chunk[:, :, 1])

    def step2_fields(i_b, a2):
        # unreachable branches may carry out-of-range ids; their slots
        # are never selected at query time -- clip for the gather.
        # Gather the raw 2-word rows and decode AFTER: the gather
        # operand stays the 40 B/run one-step table instead of eight
        # materialized full-size field arrays.
        i = jnp.clip(i_b, 0, r - 1)
        rows = jnp.take(records1, i * slots + a2, axis=0)
        return _decode1(rows[:, 0], rows[:, 1])

    def descriptor(slope_mask, i_b, c_b, y_b, a2):
        """(A, B, C, kind, flags) for one branch: slope-1 branches carry
        a composed LF2/MIS2 descriptor, constant branches resolve step 2
        at build time."""
        g = step2_fields(i_b, a2)
        # slope branch, step-2 reposition flags
        fl_mis = g["bump"] | (g["d_up"] << 1) | (g["d_dn"] << 2)
        # constant branch: evaluate step 2 on the concrete (i_b, y_b)
        off0 = g["fa"] + y_b
        ff = (off0 >= g["fb"]).astype(jnp.int32)
        j_lf = g["m"] + ff
        d_lf = off0 - ff * g["fb"]
        dn = y_b >= g["fb"]
        j_up = jnp.where(g["d_up"] == 1, pd_run, g["m"])
        d_up = jnp.where(g["d_up"] == 1, pd_off, g["fa"])
        j_dn = jnp.where(g["d_dn"] == 1, pd_run, g["m"] + g["bump"])
        d_dn = jnp.where(g["d_dn"] == 1, pd_off,
                         jnp.where(g["bump"] == 1, 0, g["fa"] + 1))
        j_c = jnp.where(g["use_lf"] == 1, j_lf, jnp.where(dn, j_dn, j_up))
        d_c = jnp.where(g["use_lf"] == 1, d_lf, jnp.where(dn, d_dn, d_up))
        fl_c = jnp.where(g["use_lf"] == 1, g["match"], 0)

        lf2 = slope_mask & (g["use_lf"] == 1)
        mis2 = slope_mask & (g["use_lf"] == 0)
        A = jnp.where(slope_mask, g["m"], j_c)
        B = jnp.where(lf2, c_b + g["fa"],
                      jnp.where(mis2,
                                jnp.clip(g["fb"] - c_b, -_BIAS, _BIAS - 1),
                                0))
        C = jnp.where(lf2, g["fb"], jnp.where(mis2, g["fa"], d_c))
        kind = jnp.where(lf2, KIND_LF2,
                         jnp.where(mis2, KIND_MIS2, KIND_CONST))
        flags = jnp.where(lf2, g["match"], jnp.where(mis2, fl_mis, fl_c))
        A = jnp.clip(A, 0, r - 1)
        if cids is None:
            return A, B, C, kind, flags
        # step-2 destination color-id pair, selected at query time by
        # ff (LF2) / down (MIS2) / nothing (CONST)
        def cid(ix_):
            return cids[jnp.clip(ix_, 0, r - 1)]
        up2 = jnp.where(g["d_up"] == 1, pd_run, g["m"])
        dn2 = jnp.where(g["d_dn"] == 1, pd_run, g["m"] + g["bump"])
        c2a = jnp.where(lf2, cid(A), jnp.where(mis2, cid(up2), cid(j_c)))
        c2b = jnp.where(lf2, cid(A + 1),
                        jnp.where(mis2, cid(dn2), cid(j_c)))
        return A, B, C, kind, flags, (c2a | (c2b << 16))

    words = [[], [], [], [], [], [], [], []]
    b_all = []
    for a1 in range(slots):
        m1 = f1["m"][:, a1]
        fa1 = f1["fa"][:, a1]
        fb1 = f1["fb"][:, a1]
        bump1 = f1["bump"][:, a1]
        match1 = f1["match"][:, a1]
        use_lf1 = f1["use_lf"][:, a1] == 1
        du1 = f1["d_up"][:, a1] == 1
        dd1 = f1["d_dn"][:, a1] == 1

        T1 = jnp.where(use_lf1, fb1 - fa1, fb1)
        T1 = jnp.clip(T1, -_BIAS, _BIAS - 1)
        # branch states: lo = (x < T1), hi = (x >= T1)
        i_up = jnp.where(du1, pd_run, m1)
        y_up = jnp.where(du1, pd_off, fa1)
        i_dn = jnp.where(dd1, pd_run, m1 + bump1)
        y_dn = jnp.where(dd1, pd_off, jnp.where(bump1 == 1, 0, fa1 + 1))
        i_lo = jnp.where(use_lf1, m1, i_up)
        c_lo = jnp.where(use_lf1, fa1, 0)
        y_lo = jnp.where(use_lf1, 0, y_up)
        i_hi = jnp.where(use_lf1, m1 + 1, i_dn)
        c_hi = jnp.where(use_lf1, fa1 - fb1, 0)
        y_hi = jnp.where(use_lf1, 0, y_dn)

        for a2 in range(slots):
            dl = descriptor(use_lf1, i_lo, c_lo, y_lo, a2)
            dh = descriptor(use_lf1, i_hi, c_hi, y_hi, a2)
            Al, Bl, Cl, kl, fl = dl[:5]
            Ah, Bh, Ch, kh, fh = dh[:5]
            # (Ah >> 16) << 23 reaches bit 31: int32 wrap is intended,
            # the decode masks the bit pattern back out
            words[0].append((T1 + _BIAS)
                            | (match1 << 13)
                            | ((Al >> 16) << 14)
                            | ((Ah >> 16) << 23))
            words[1].append((Bl + _BIAS) | (Cl << 13) | (kl << 25)
                            | (fl << 27))
            words[2].append((Bh + _BIAS) | (Ch << 13) | (kh << 25)
                            | (fh << 27))
            words[3].append((Al & 0xFFFF) | ((Ah & 0xFFFF) << 16))
            b_all.extend([Bl, Bh])
            if cids is not None:
                cid1_lo = cids[jnp.clip(i_lo, 0, r - 1)]
                cid1_hi = cids[jnp.clip(i_hi, 0, r - 1)]
                words[4].append(cid1_lo | (cid1_hi << 16))
                words[5].append(dl[5])
                words[6].append(dh[5])
                words[7].append(jnp.zeros_like(cid1_lo))

    # [ch, slots^2] per word -> [ch*slots^2, nwords]
    packed = jnp.stack(
        [jnp.stack(w, axis=1).reshape(-1) for w in words if w],
        axis=1).astype(jnp.int32)
    ball = jnp.stack(b_all)
    out = jax.lax.dynamic_update_slice(out, packed,
                                       (c0 * (slots * slots), 0))
    return out, ball.min(), ball.max()


_compose_chunk_jit = jax.jit(
    _compose_chunk, static_argnames=("r", "slots", "p_dollar", "ch"),
    donate_argnums=(0,))

# compose working set is ~2 * nwords * slots^2 * 4 B per chunk run
# (~800 B/run for the 4-word PML records): 2^21 runs ~ 1.7 GB scratch
COMPOSE_CHUNK = 1 << 21


def compose_records(records1, r: int, slots: int, p_dollar, cids=None,
                    chunk_runs: int = 0):
    """Host driver for the chunked compose: allocate the output table
    once and fill it chunk-by-chunk with buffer donation (in-place).
    The last chunk re-composes a few overlapping runs rather than
    recompiling for a ragged tail."""
    assert chunk_runs >= 0, f"chunk_runs must be >= 0, got {chunk_runs}"
    ch = min(r, chunk_runs or COMPOSE_CHUNK)
    nw = 4 if cids is None else 8
    out = jnp.zeros((r * slots * slots, nw), jnp.int32)
    bmin, bmax = [], []
    starts = list(range(0, r - ch, ch)) + [r - ch]
    for c0 in starts:
        out, bn, bx = _compose_chunk_jit(out, records1, cids,
                                         jnp.int32(c0), r=r, slots=slots,
                                         p_dollar=p_dollar, ch=ch)
        bmin.append(int(bn))
        bmax.append(int(bx))
    return out, (min(bmin), max(bmax))


def build_fused2_index(fi: FusedIndex) -> Fused2Index:
    """Compose the one-step records into paired two-step records."""
    r, sigma = fi.r, fi.sigma
    assert r < MAX_RUNS, (
        f"paired records hold 25-bit run ids; r={r} exceeds {MAX_RUNS} "
        f"(use the one-step fused engine)")
    slots = sigma + 1
    records, (bmin, bmax) = compose_records(fi.records, r=r, slots=slots,
                                            p_dollar=fi.p_dollar)
    assert bmin >= -_BIAS and bmax < _BIAS, (
        "composed B field out of its 13-bit range -- corrupt index?")
    return Fused2Index(
        r=r, sigma=sigma, records=records,
        start_idx=fi.start_idx, start_offset=fi.start_offset,
        p_dollar=fi.p_dollar, alphamap_query=fi.alphamap_query)



def _fused2_decode(rec: jax.Array, offset: jax.Array, p_dollar):
    """Shared paired-record decode on a gathered [lanes, >=4] record.
    Returns (new_idx, new_off, match1, match2, hi, ff, down, kind) --
    the selectors are reused by the color variant."""
    w0 = rec[:, 0]
    w3 = rec[:, 3]
    T1 = (w0 & 0x1FFF) - _BIAS
    match1 = (w0 >> 13) & 1
    hi = offset >= T1
    wb = jnp.where(hi, rec[:, 2], rec[:, 1])
    A = jnp.where(hi,
                  ((w3 >> 16) & 0xFFFF) | (((w0 >> 23) & 0x1FF) << 16),
                  (w3 & 0xFFFF) | (((w0 >> 14) & 0x1FF) << 16))
    B = (wb & 0x1FFF) - _BIAS
    C = (wb >> 13) & 0xFFF
    kind = (wb >> 25) & 3
    flags = (wb >> 27) & 7

    # LF2: standard bounded-ff decode with precomposed fields
    off0 = B + offset
    ff = (off0 >= C).astype(jnp.int32)
    lf_idx = A + ff
    lf_off = off0 - ff * C

    # MIS2: one-step mismatch anchor decode
    pd_run, pd_off = p_dollar
    bump = flags & 1
    d_up = (flags >> 1) & 1
    d_dn = (flags >> 2) & 1
    down = offset >= B
    up_run = jnp.where(d_up == 1, pd_run, A)
    up_off = jnp.where(d_up == 1, pd_off, C)
    dn_run = jnp.where(d_dn == 1, pd_run, A + bump)
    dn_off = jnp.where(d_dn == 1, pd_off, jnp.where(bump == 1, 0, C + 1))
    mis_idx = jnp.where(down, dn_run, up_run)
    mis_off = jnp.where(down, dn_off, up_off)

    new_idx = jnp.where(kind == KIND_LF2, lf_idx,
                        jnp.where(kind == KIND_MIS2, mis_idx, A))
    new_off = jnp.where(kind == KIND_LF2, lf_off,
                        jnp.where(kind == KIND_MIS2, mis_off, C))
    match2 = jnp.where(kind == KIND_MIS2, 0, flags & 1)
    return new_idx, new_off, match1, match2, hi, ff, down, kind


_FUSED2_FMT = 2  # on-disk cache format (2: 25-bit A fields in w0)


def save_fused2_index(f2: Fused2Index, path: str):
    """Persist the composed paired records (build --paired-cache), the
    analogue of engine/fused.py's save_fused_index."""
    np.savez(path, records=np.asarray(f2.records),
             meta=np.array([f2.r, f2.sigma, f2.start_idx, f2.start_offset,
                            f2.p_dollar[0], f2.p_dollar[1], _FUSED2_FMT],
                           dtype=np.int64),
             alphamap_query=f2.alphamap_query)


def load_fused2_index(path: str) -> Fused2Index:
    z = np.load(path)
    meta = [int(x) for x in z["meta"]]
    if len(meta) < 7 or meta[6] != _FUSED2_FMT:
        raise ValueError(f"{path}: stale paired-record cache; rebuild "
                         f"with `build --paired-cache`")
    r, sigma, start_idx, start_offset, pd_run, pd_off = meta[:6]
    return Fused2Index(r=r, sigma=sigma, records=jnp.asarray(z["records"]),
                       start_idx=start_idx, start_offset=start_offset,
                       p_dollar=(pd_run, pd_off),
                       alphamap_query=z["alphamap_query"])


def fused2_step(records: jax.Array, slots: int, p_dollar, state, a12):
    """Two PML base steps from a single 16-byte gather.
    a12 = a1 * slots + a2.  Emits (ml1, ml2)."""
    idx, offset, ml = state
    rec = jnp.take(records, idx * (slots * slots) + a12, axis=0)
    new_idx, new_off, match1, match2, *_ = _fused2_decode(rec, offset,
                                                          p_dollar)
    ml1 = jnp.where(match1 == 1, ml + 1, 0)
    ml2 = jnp.where(match2 == 1, ml1 + 1, 0)
    return (new_idx, new_off, ml2), (ml1, ml2)


def pack_pairs(alphas: np.ndarray, sigma: int):
    """Host-side pair packing shared by every paired engine: reverse
    already applied, [lanes, W] alphabet slots -> ([W2, lanes] combined
    a1*(sigma+1)+a2, W).  Odd widths pad the scan tail (past every
    read's end) with the illegal slot.  Ships uint8 when the pair range
    fits (sub-int32 xs are widened ONCE on device by the scan
    wrappers); wider alphabets fall back to int32."""
    slots = sigma + 1
    W = alphas.shape[1]
    if W % 2:
        alphas = np.concatenate(
            [alphas, np.full((alphas.shape[0], 1), sigma, alphas.dtype)],
            axis=1)
    a12 = (alphas[:, 0::2].astype(np.int32) * slots
           + alphas[:, 1::2]).T
    dtype = np.uint8 if slots * slots - 1 <= 0xFF else np.int32
    return np.ascontiguousarray(a12).astype(dtype), W


@jax.jit
def _fused2_scan_carry(fi: Fused2Index, a12_t: jax.Array, state):
    """a12_t: [W2, lanes] combined char pairs; emits ml [2*W2, lanes].
    Pairs ship as uint8 (a12 <= slots^2-1 = 24 for DNA) and widen ONCE
    on device -- per-step slicing of sub-int32 xs is ~3x slower."""
    slots = fi.sigma + 1
    a12_t = a12_t.astype(jnp.int32)

    def step(st, a):
        return fused2_step(fi.records, slots, fi.p_dollar, st, a)

    state, (ml1, ml2) = jax.lax.scan(step, state, a12_t)
    W2, lanes = a12_t.shape
    ml = jnp.stack([ml1, ml2], axis=1).reshape(2 * W2, lanes)
    return state, ml


class Fused2PMLEngine:
    """Batched PML at half a gather per base."""

    CHUNK = 1024  # pairs per carried chunk (2048 bases)

    def __init__(self, fi: Fused2Index):
        self.fi = fi

    def query_batch_device(self, batch: ReadBatch) -> jax.Array:
        fi = self.fi
        slots = fi.sigma + 1
        a12, W = pack_pairs(fi.alphamap_query[batch.seqs[:, ::-1]],
                            fi.sigma)
        a12_t = jnp.asarray(a12)
        W2, lanes = a12_t.shape
        state = (jnp.full((lanes,), fi.start_idx, jnp.int32),
                 jnp.full((lanes,), fi.start_offset, jnp.int32),
                 jnp.zeros((lanes,), jnp.int32))
        if W2 <= self.CHUNK:
            _, ml = _fused2_scan_carry(self.fi, a12_t, state)
            return ml[:W]
        pad = (-W2) % self.CHUNK
        if pad:
            illegal = fi.sigma * slots + fi.sigma
            a12_t = jnp.concatenate(
                [a12_t, jnp.full((pad, lanes), illegal, a12_t.dtype)])
        mls = []
        for c0 in range(0, W2 + pad, self.CHUNK):
            state, ml = _fused2_scan_carry(
                self.fi, jax.lax.slice_in_dim(a12_t, c0, c0 + self.CHUNK),
                state)
            mls.append(ml)
        return jnp.concatenate(mls)[:W]

    def query_batch(self, batch: ReadBatch) -> List[List[int]]:
        ml = np.asarray(self.query_batch_device(batch))
        out = []
        for lane in range(batch.lanes):
            L = int(batch.lengths[lane])
            out.append(ml[:L, lane].tolist())
        return out


# ---------------------------------------------------------------------------
# Paired Movi Color: PML + per-base color ids at half a gather per base


@dataclass
class Fused2ColorIndex:
    f2: Fused2Index             # records are 8-word color records
    num_colors: int


jax.tree_util.register_dataclass(
    Fused2ColorIndex, data_fields=["f2"], meta_fields=["num_colors"])


def build_fused2_color_index(fi: FusedIndex, ct) -> Fused2ColorIndex:
    """Compose paired records widened with both steps' destination color
    ids (the paired analogue of engine/fused_color.py's 3-word record).
    Requires the kept-set count to fit 16 bits, like the packed color
    path."""
    r, sigma = fi.r, fi.sigma
    assert r < MAX_RUNS
    C = len(ct.unique_doc_sets)
    assert C + 1 <= 0xFFFF, "paired color needs <= 2^16-2 unique sets"
    slots = sigma + 1
    cids = jnp.asarray(
        np.minimum(np.asarray(ct.doc_set_inds), C).astype(np.int32))
    records, (bmin, bmax) = compose_records(fi.records, r=r, slots=slots,
                                            p_dollar=fi.p_dollar, cids=cids)
    assert bmin >= -_BIAS and bmax < _BIAS
    f2 = Fused2Index(
        r=r, sigma=sigma, records=records,
        start_idx=fi.start_idx, start_offset=fi.start_offset,
        p_dollar=fi.p_dollar, alphamap_query=fi.alphamap_query)
    return Fused2ColorIndex(f2=f2, num_colors=C)


def fused2_color_step(records: jax.Array, slots: int, p_dollar, state,
                      a12):
    """Two PML base steps + both post-LF color ids from ONE 32-byte
    gather (the shared decode plus the word-4..6 color selectors)."""
    idx, offset, ml = state
    rec = jnp.take(records, idx * (slots * slots) + a12, axis=0)
    (new_idx, new_off, match1, match2,
     hi, ff, down, kind) = _fused2_decode(rec, offset, p_dollar)
    ml1 = jnp.where(match1 == 1, ml + 1, 0)
    ml2 = jnp.where(match2 == 1, ml1 + 1, 0)

    # color selectors: step 1 by the branch bit, step 2 by ff/down
    w4 = rec[:, 4]
    cid1 = jnp.where(hi, (w4 >> 16) & 0xFFFF, w4 & 0xFFFF)
    wc2 = jnp.where(hi, rec[:, 6], rec[:, 5])
    sel2 = jnp.where(kind == KIND_LF2, ff,
                     jnp.where(kind == KIND_MIS2,
                               down.astype(jnp.int32), 0))
    cid2 = jnp.where(sel2 == 1, (wc2 >> 16) & 0xFFFF, wc2 & 0xFFFF)
    return (new_idx, new_off, ml2), (ml1, ml2, cid1, cid2)


@jax.jit
def _fused2_color_scan_carry(ci: Fused2ColorIndex, a12_t: jax.Array,
                             state):
    f2 = ci.f2
    slots = f2.sigma + 1
    a12_t = a12_t.astype(jnp.int32)

    def step(st, a):
        return fused2_color_step(f2.records, slots, f2.p_dollar, st, a)

    state, (ml1, ml2, c1, c2) = jax.lax.scan(step, state, a12_t)
    W2, lanes = a12_t.shape
    ml = jnp.stack([ml1, ml2], axis=1).reshape(2 * W2, lanes)
    color = jnp.stack([c1, c2], axis=1).reshape(2 * W2, lanes)
    return state, ml, color


@jax.jit
def _fused2_color_scan_carry_es(ci: Fused2ColorIndex, a12_t: jax.Array,
                                t0: int, lens: jax.Array, state):
    """Early-stop variant: carries (csum, stopped) per lane across the
    paired chunk (two stop-rule checks per pair step) and returns
    all_retired for the host chunk loop (chunk-level lane retirement,
    read_processor.cpp:240-250)."""
    from .fused_color import _es_check

    f2 = ci.f2
    slots = f2.sigma + 1
    a12_t = a12_t.astype(jnp.int32)
    core, csum, stopped = state
    W2 = a12_t.shape[0]
    ks = t0 + 2 * jnp.arange(W2, dtype=jnp.int32)

    def step(st, xs):
        core, csum, stopped = st
        a, t1 = xs
        core, (ml1, ml2, c1, c2) = fused2_color_step(
            f2.records, slots, f2.p_dollar, core, a)
        csum, stopped = _es_check(csum, stopped, ml1, t1, lens)
        csum, stopped = _es_check(csum, stopped, ml2, t1 + 1, lens)
        return (core, csum, stopped), (ml1, ml2, c1, c2)

    (core, csum, stopped), (ml1, ml2, c1, c2) = jax.lax.scan(
        step, (core, csum, stopped), (a12_t, ks))
    lanes = a12_t.shape[1]
    ml = jnp.stack([ml1, ml2], axis=1).reshape(2 * W2, lanes)
    color = jnp.stack([c1, c2], axis=1).reshape(2 * W2, lanes)
    retired = stopped | (t0 + 2 * W2 >= lens)
    return ((core, csum, stopped), ml, color, jnp.all(retired))


class Fused2ColorEngine:
    """Multi-class classification at half a gather per base: the paired
    device scan emits (ml, color) with the same contract as
    FusedColorEngine, whose host-side vote tally and early-stop
    retirement are reused via delegation."""

    CHUNK = 1024

    def __init__(self, ci: Fused2ColorIndex, ct, **kw):
        from .fused_color import FusedColorEngine

        self.ci = ci
        # the host tally needs no device index: delegate with ci=None
        self._host = FusedColorEngine(None, ct, **kw)
        self.last_scanned_rows = 0  # chunk-retirement observability

    def query_batch_device(self, batch: ReadBatch):
        f2 = self.ci.f2
        slots = f2.sigma + 1
        a12, W = pack_pairs(f2.alphamap_query[batch.seqs[:, ::-1]],
                            f2.sigma)
        a12_t = jnp.asarray(a12)
        W2, lanes = a12_t.shape
        core = (jnp.full((lanes,), f2.start_idx, jnp.int32),
                jnp.full((lanes,), f2.start_offset, jnp.int32),
                jnp.zeros((lanes,), jnp.int32))
        self.last_scanned_rows = W
        if W2 <= self.CHUNK:
            _, ml, color = _fused2_color_scan_carry(self.ci, a12_t, core)
            return ml[:W], color[:W]
        pad = (-W2) % self.CHUNK
        if pad:
            illegal = f2.sigma * slots + f2.sigma
            a12_t = jnp.concatenate(
                [a12_t, jnp.full((pad, lanes), illegal, a12_t.dtype)])
        early = self._host.early_stop
        if early:
            lens = jnp.asarray(batch.lengths.astype(np.int32))
            state = (core, jnp.zeros((lanes,), jnp.int32),
                     jnp.zeros((lanes,), bool))
        mls, colors = [], []
        scanned = 0
        for c0 in range(0, W2 + pad, self.CHUNK):
            sl = jax.lax.slice_in_dim(a12_t, c0, c0 + self.CHUNK)
            if early:
                state, ml, color, all_ret = _fused2_color_scan_carry_es(
                    self.ci, sl, 2 * c0, lens, state)
            else:
                core, ml, color = _fused2_color_scan_carry(
                    self.ci, sl, core)
            mls.append(ml)
            colors.append(color)
            scanned = min(2 * (c0 + self.CHUNK), W)
            if early and scanned < W and bool(np.asarray(all_ret)):
                break
        ml = jnp.concatenate(mls)[:W]
        color = jnp.concatenate(colors)[:W]
        if scanned < W:
            # chunk-level lane retirement: every lane's stop point or
            # read end lies within the scanned prefix, so the zero fill
            # is never read by the host trim
            fill = W - ml.shape[0]
            ml = jnp.concatenate([ml, jnp.zeros((fill, lanes), ml.dtype)])
            color = jnp.concatenate(
                [color, jnp.zeros((fill, lanes), color.dtype)])
        self.last_scanned_rows = scanned
        return ml, color

    def query_batch(self, batch: ReadBatch):
        from .fused_color import _early_stop_len

        ml_d, color_d = self.query_batch_device(batch)
        host = self._host
        ml = np.asarray(ml_d)
        color = np.asarray(color_d)
        out = []
        for lane in range(batch.lanes):
            L = int(batch.lengths[lane])
            pmls = ml[:L, lane]
            cids = color[:L, lane]
            if host.early_stop:
                n = _early_stop_len(pmls, L)
                pmls = pmls[:n]
                cids = cids[:n]
            cell, rep_colors = host._tally(pmls, cids, L)
            out.append((pmls.tolist(), cell, rep_colors))
        return out
