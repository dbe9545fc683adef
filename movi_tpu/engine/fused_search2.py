"""Paired backward-search engines: count and ZML at ONE record gather
per base (two composed steps per gather) instead of two.

The one-step engine (engine/fused_search.py) costs 2 gathered rows per
base (interval start + end) = ~44 Mbases/s HBM.  Like the paired PML
engine (engine/fused2.py), TWO backward-search steps compose into one
record because each per-direction step is a single affine-or-constant
offset transform selected by one comparison:

  update_interval (move_structure_search.cpp:4-64) maps the direction's
  run to the nearest char-matching run -- a compose-time constant per
  (run, char) -- and its offset to either the carried offset (dest ==
  run) or a constant (0 for the start, n-1 for the end); LF_move then
  adds a constant and fast-forwards on one comparison (bound_ff=1).
  So a step is the micro-decode

      off0 = B + u * off_in;  ff = off0 >= C
      (run', off') = (A + ff, off0 - ff * C)

  with per-(run, char) fields A (LF dest run), B (LF offset, plus the
  n-1 end reset), C (ff threshold, GUARD when the dest is the last
  run), u (1 iff the dest run IS the current run, i.e. the carried
  offset survives the update).  Step 2's fields depend on the step-1
  branch (run' is A1 or A1+1), so the record carries them per branch.

Emptiness needs no stored comparison runs: the reference's check
"first matching run above start > interval end"
(move_structure_search.cpp:311-333, mirrored by fused_bs_step) is
equivalent to the post-LF interval being CROSSED -- LF is strictly
monotone on the positions holding one character, so a nonempty updated
interval stays ordered and an empty one (start's next match lies past
the end's) inverts.  "No matching run at all" folds in via +/-inf
sentinel destinations.  This drops both next-run ids from the record:
147 bits, packed in SIX int32 words per (run, a1, a2) per direction:

  w0: A1 (0-24) | u1 (25) | u2_lo (26) | u2_hi (27)
  w1: A2_lo (0-24)            w2: A2_hi (0-24)
  w3: B1 (0-11) | C1 (12-23)  w4/w5: B2/C2 for the lo/hi branch

The mid-pair interval is load-bearing (the reference reports the
interval BEFORE the emptying step, and ZML restarts mid-pair): the
step-1 micro-decode of both directions reconstructs it.  ZML's
mid-pair restart is a pure function of (a1, a2) -- one backward-search
step from the init interval of a1 -- precomputed into a sigma^2-entry
table selected one-hot, NOT a second record gather.

Memory: 2 directions * sigma^2 * 24 B per run (768 B/run for DNA); the
speed layout for count/ZML.  The 25-bit A fields allow r < 2^25 (the
same id envelope as the paired PML layout), but 768 B/run caps the
layout near r ~ 1.7e7 on a 16 GB chip first.  Bit-exact vs
ScalarEngine and the one-step engines (tests/test_fused_search2.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .fused_search import FusedSearchIndex, _onehot_rows
from ..index.structure import MoveIndex
from ..io.fastx import ReadBatch

GUARD = 0xFFF            # C-field value meaning "no fast forward"
SENT_HI = 0x1FFFFFF      # +inf run sentinel (start side, no match)
MAX_RUNS = 1 << 25       # A fields are 25-bit (u bits sit at 25-27)
_AQ_BIAS = 2             # pair packing biases chars {-2,-1,0..} by +2


@dataclass
class FusedSearch2Index:
    r: int
    sigma: int
    # both directions concatenated: rows [0, r*sigma^2) are the "down"
    # (interval start) records, rows [r*sigma^2, 2*r*sigma^2) the "up"
    # (interval end) records -- one table so a step's two fetches issue
    # as ONE gather of 2*lanes indices instead of two
    rec_all: jax.Array    # int32 [2*r*sigma^2, 6]
    # init_rec[a+1] = (first_run, first_offset, last_run, last_offset)
    init_rec: jax.Array   # int32 [sigma+1, 4]
    # restart_rec[a1*sigma+a2] = one bs step from init(a1) with a2:
    # (rs, os, re, oe, empty) -- ZML's mid-pair restart (tiny)
    restart_rec: jax.Array  # int32 [sigma^2, 5]
    all_p: jax.Array      # int32 [r+1] (final interval counts)
    alphamap_query: np.ndarray


jax.tree_util.register_dataclass(
    FusedSearch2Index,
    data_fields=["rec_all", "init_rec", "restart_rec", "all_p",
                 "alphamap_query"],
    meta_fields=["r", "sigma"],
)


def _compose_search2_chunk(out, id_a, off_a, n_a, nu, nd, c0, r: int,
                           sigma: int, ch: int):
    """Compose the per-direction two-step records for runs [c0, c0+ch)
    ON DEVICE (gathers + selects over [ch] vectors, like
    engine/fused2.py's compose) and write them into `out` (donated):
    the final table (768 B/run) never crosses the host-device link, and
    chunking keeps the compose peak at table + O(chunk) instead of
    2x table."""
    idxs = c0 + jnp.arange(ch, dtype=jnp.int32)
    cum = jnp.where(id_a < r - 1, n_a[jnp.clip(id_a, 0, r - 1)], GUARD)

    def fields(tab_a, up: bool, cur_run):
        """(A, B, C, u) of one micro-step for char table row tab_a
        evaluated at runs cur_run (sentinels folded in)."""
        d = tab_a[jnp.clip(cur_run, 0, r - 1)].astype(jnp.int32)
        ex = (d < r) & (cur_run < r)
        dc = jnp.clip(d, 0, r - 1)
        keep = ex & (d == cur_run)
        sent = 0 if up else SENT_HI
        A = jnp.where(ex, id_a[dc], sent)
        reset = (n_a[dc] - 1) if up else 0
        B = jnp.where(ex, off_a[dc] + jnp.where(keep, 0, reset), 0)
        C = jnp.where(ex, cum[dc], GUARD)
        return A, B, C, keep.astype(jnp.int32)

    words = [[], [], [], [], [], []]
    for up, tab in ((False, nd), (True, nu)):
        for a1 in range(sigma):
            A1, B1, C1, u1 = fields(tab[a1], up, idxs)
            for a2 in range(sigma):
                A2l, B2l, C2l, u2l = fields(tab[a2], up, A1)
                A2h, B2h, C2h, u2h = fields(tab[a2], up, A1 + 1)
                words[0].append(A1 | (u1 << 25) | (u2l << 26)
                                | (u2h << 27))
                words[1].append(A2l)
                words[2].append(A2h)
                words[3].append(B1 | (C1 << 12))
                words[4].append(B2l | (C2l << 12))
                words[5].append(B2h | (C2h << 12))
    # [ch] per (dir, a1, a2) -> run-major [2, ch*sigma^2, 6]; the two
    # direction slabs land at rows c0*S2 and r*S2 + c0*S2
    S2 = sigma * sigma
    cols = jnp.stack(
        [jnp.stack(w).reshape(2, S2, ch).transpose(0, 2, 1)
         .reshape(2, ch * S2) for w in words],
        axis=2).astype(jnp.int32)
    out = jax.lax.dynamic_update_slice(out, cols[0], (c0 * S2, 0))
    out = jax.lax.dynamic_update_slice(out, cols[1],
                                       (r * S2 + c0 * S2, 0))
    return out


_compose_search2_chunk_jit = jax.jit(
    _compose_search2_chunk, static_argnames=("r", "sigma", "ch"),
    donate_argnums=(0,))

# compose working set is ~2 * 2 * sigma^2 * 6 * 4 B per chunk run
# (~1.5 kB/run for DNA): 2^20 runs ~ 1.6 GB scratch
COMPOSE_CHUNK = 1 << 20


def compose_search2(id_a, off_a, n_a, nu, nd, r: int, sigma: int,
                    chunk_runs: int = 0):
    """Host driver for the chunked compose (see engine/fused2.py's
    compose_records): allocate once, fill chunk-by-chunk with buffer
    donation; the last chunk re-composes overlapping runs rather than
    recompiling for a ragged tail."""
    assert chunk_runs >= 0, f"chunk_runs must be >= 0, got {chunk_runs}"
    ch = min(r, chunk_runs or COMPOSE_CHUNK)
    out = jnp.zeros((2 * r * sigma * sigma, 6), jnp.int32)
    for c0 in list(range(0, r - ch, ch)) + [r - ch]:
        out = _compose_search2_chunk_jit(out, id_a, off_a, n_a, nu, nd,
                                         jnp.int32(c0), r=r, sigma=sigma,
                                         ch=ch)
    return out


def _restart_table(ix: MoveIndex) -> np.ndarray:
    """One backward-search step from init(a1) with char a2, for every
    (a1, a2) -- the ZML mid-pair restart (host numpy; sigma^2 entries)."""
    r, sigma = ix.r, ix.sigma
    nu, nd = ix.next_tables_search()
    id_a = ix.id_arr.astype(np.int64)
    off_a = ix.offset_arr.astype(np.int64)
    n_a = ix.n_arr.astype(np.int64)
    out = np.zeros((sigma * sigma, 5), dtype=np.int32)
    for a1 in range(sigma):
        rs = int(ix.first_runs[a1 + 1])
        os_ = int(ix.first_offsets[a1 + 1])
        re = int(ix.last_runs[a1 + 1])
        oe = int(ix.last_offsets[a1 + 1])
        for a2 in range(sigma):
            k = a1 * sigma + a2
            ds = int(nd[a2][rs])
            de = int(nu[a2][re]) if re < r else r
            if ds >= r or ds > re:
                out[k] = (0, 0, 0, 0, 1)
                continue
            os1 = os_ if ds == rs else 0
            oe1 = oe if de == re else int(n_a[de]) - 1

            def lf(d, o):
                run, off0 = int(id_a[d]), int(off_a[d]) + o
                if run < r - 1 and off0 >= n_a[run]:
                    off0 -= int(n_a[run])
                    run += 1
                return run, off0

            nrs, nos = lf(ds, os1)
            nre, noe = lf(de, oe1)
            out[k] = (nrs, nos, nre, noe, 0)
    return out


def build_fused_search2_index(ix: MoveIndex) -> FusedSearch2Index:
    r, sigma = ix.r, ix.sigma
    assert r < MAX_RUNS, (
        f"paired search records hold 25-bit run ids; r={r} exceeds "
        f"{MAX_RUNS} (use the one-step fused search engine)")
    assert sigma + _AQ_BIAS <= 8, "pair packing needs sigma <= 6"
    n64 = ix.n_arr.astype(np.int64)
    lf_abs = ix.all_p[ix.id_arr] + ix.offset_arr.astype(np.int64)
    e = lf_abs + n64 - 1
    id_end = np.searchsorted(ix.all_p[:-1], e, side="right") - 1
    assert int(np.max(id_end - ix.id_arr)) <= 1, (
        "paired search requires an index built with bound_ff=1")
    assert int(n64.max()) <= GUARD // 2, (
        "paired search records pack 12-bit B/C fields")

    nu, nd = ix.next_tables_search()
    rec_all = compose_search2(
        jnp.asarray(ix.id_arr.astype(np.int32)),
        jnp.asarray(ix.offset_arr.astype(np.int32)),
        jnp.asarray(ix.n_arr.astype(np.int32)),
        jnp.asarray(nu.astype(np.int32)),
        jnp.asarray(nd.astype(np.int32)),
        r=r, sigma=sigma)

    alphamap_query = np.full(256, -1, dtype=np.int32)
    for a, ch in enumerate(ix.alphabet):
        alphamap_query[ch] = a
    from ..constants import SEPARATOR
    if ix.separators:
        alphamap_query[SEPARATOR] = -1

    init_rec = np.stack([ix.first_runs, ix.first_offsets,
                         ix.last_runs, ix.last_offsets],
                        axis=1).astype(np.int32)
    return FusedSearch2Index(
        r=r, sigma=sigma, rec_all=rec_all,
        init_rec=jnp.asarray(init_rec),
        restart_rec=jnp.asarray(_restart_table(ix)),
        all_p=jnp.asarray(ix.all_p.astype(np.int32)),
        alphamap_query=alphamap_query)


_S2_FMT = 2  # on-disk cache format (2: 25-bit A fields)


def save_fused_search2_index(s2: FusedSearch2Index, path: str):
    np.savez(path, rec_all=np.asarray(s2.rec_all),
             init_rec=np.asarray(s2.init_rec),
             restart_rec=np.asarray(s2.restart_rec),
             all_p=np.asarray(s2.all_p),
             alphamap_query=s2.alphamap_query,
             meta=np.array([s2.r, s2.sigma, _S2_FMT], dtype=np.int64))


def load_fused_search2_index(path: str) -> FusedSearch2Index:
    z = np.load(path)
    meta = [int(x) for x in z["meta"]]
    if len(meta) < 3 or meta[2] != _S2_FMT:
        raise ValueError(f"{path}: stale paired search cache; rebuild "
                         f"with `build --paired-cache`")
    return FusedSearch2Index(
        r=meta[0], sigma=meta[1], rec_all=jnp.asarray(z["rec_all"]),
        init_rec=jnp.asarray(z["init_rec"]),
        restart_rec=jnp.asarray(z["restart_rec"]),
        all_p=jnp.asarray(z["all_p"]),
        alphamap_query=z["alphamap_query"])


def _micro(A, B, C, u, off_in):
    off0 = B + u * off_in
    ff = (off0 >= C).astype(jnp.int32)
    return A + ff, off0 - ff * C, ff


def _decode_dir(rec, off_in):
    """Two composed micro-steps of one direction from a gathered
    [lanes, 6] record.  Returns (mid_run, mid_off, fin_run, fin_off)."""
    w0 = rec[:, 0]
    A1 = w0 & 0x1FFFFFF
    u1 = (w0 >> 25) & 1
    w3 = rec[:, 3]
    m_run, m_off, ff1 = _micro(A1, w3 & GUARD, (w3 >> 12) & GUARD, u1,
                               off_in)
    hi = ff1 == 1
    A2 = jnp.where(hi, rec[:, 2], rec[:, 1]) & 0x1FFFFFF
    wbc = jnp.where(hi, rec[:, 5], rec[:, 4])
    u2 = jnp.where(hi, (w0 >> 27) & 1, (w0 >> 26) & 1)
    f_run, f_off, _ = _micro(A2, wbc & GUARD, (wbc >> 12) & GUARD, u2,
                             m_off)
    return m_run, m_off, f_run, f_off


def _crossed(sr, so, er, eo):
    return (sr > er) | ((sr == er) & (so > eo))


def fused2_bs_step(s2: FusedSearch2Index, rs, os_, re, oe, a12, l1, l2):
    """TWO backward_search_steps from one gather of 2*lanes composed
    records.  Returns (mid interval, final interval, empty1, empty2);
    empty2 is meaningful only where ~empty1 (garbage otherwise -- the
    callers gate it)."""
    r, sigma = s2.r, s2.sigma
    S2 = sigma * sigma
    lanes = rs.shape[0]
    a12c = jnp.clip(a12, 0, S2 - 1)
    keys = jnp.concatenate([
        jnp.clip(rs, 0, r - 1) * S2 + a12c,
        r * S2 + jnp.clip(re, 0, r - 1) * S2 + a12c])
    both = jnp.take(s2.rec_all, keys, axis=0)
    ms_run, ms_off, fs_run, fs_off = _decode_dir(both[:lanes], os_)
    me_run, me_off, fe_run, fe_off = _decode_dir(both[lanes:], oe)
    empty1 = ~l1 | _crossed(ms_run, ms_off, me_run, me_off)
    empty2 = ~l2 | _crossed(fs_run, fs_off, fe_run, fe_off)
    return ((ms_run, ms_off, me_run, me_off),
            (fs_run, fs_off, fe_run, fe_off), empty1, empty2)


def pack_search_pairs(alphas: np.ndarray, sigma: int):
    """[lanes, W] char slots in {-2 (beyond read), -1 (illegal),
    0..sigma-1} -> ([W2, lanes] packed (a1+2)*8+(a2+2) uint8, W).  Odd
    widths pad the tail with the beyond-read sentinel."""
    W = alphas.shape[1]
    if W % 2:
        alphas = np.concatenate(
            [alphas, np.full((alphas.shape[0], 1), -2, alphas.dtype)],
            axis=1)
    v = ((alphas[:, 0::2].astype(np.int32) + _AQ_BIAS) * 8
         + (alphas[:, 1::2] + _AQ_BIAS)).T
    return np.ascontiguousarray(v).astype(np.uint8), W


def _unpack_pair(v):
    return (v >> 3) - _AQ_BIAS, (v & 7) - _AQ_BIAS


_IKEYS = ("rs", "os", "re", "oe")


def _count_pair_body(s2: FusedSearch2Index):
    def body(state, v):
        a1, a2 = _unpack_pair(v)
        alive = ~state["done"]
        mid, fin, empty1, empty2 = fused2_bs_step(
            s2, state["rs"], state["os"], state["re"], state["oe"],
            jnp.maximum(a1, 0) * s2.sigma + jnp.maximum(a2, 0),
            a1 >= 0, a2 >= 0)
        ok1 = alive & ~empty1
        ok2 = ok1 & ~empty2
        new = dict(state)
        for k, m, f in zip(_IKEYS, mid, fin):
            new[k] = jnp.where(ok2, f, jnp.where(ok1, m, state[k]))
        new["matched"] = (state["matched"] + ok1.astype(jnp.int32)
                          + ok2.astype(jnp.int32))
        new["done"] = state["done"] | (alive & (empty1 | empty2))
        return new, None
    return body


@jax.jit
def _count2_init(s2: FusedSearch2Index, a0):
    a0 = a0.astype(jnp.int32)
    legal0 = a0 >= 0
    rec = jnp.take(s2.init_rec, jnp.maximum(a0, 0) + 1, axis=0)
    return dict(rs=rec[:, 0], os=rec[:, 1], re=rec[:, 2], oe=rec[:, 3],
                done=~legal0,
                matched=jnp.where(legal0, 1, 0).astype(jnp.int32))


@jax.jit
def _count2_carry(s2: FusedSearch2Index, pairs_t: jax.Array, state):
    state, _ = jax.lax.scan(_count_pair_body(s2), state,
                            pairs_t.astype(jnp.int32))
    return state


SCAN_CHUNK = 1024  # pairs per carried chunk (2048 bases)


def fused2_count_scan(s2: FusedSearch2Index, a0, pairs_t: jax.Array):
    """Count query (query_backward_search) over paired records.
    a0: [lanes] first char slots; pairs_t: [W2, lanes] packed pairs of
    the remaining chars.  Returns (matched, count)."""
    state = _count2_init(s2, a0)
    W2 = pairs_t.shape[0]
    for c0 in range(0, W2, SCAN_CHUNK):
        state = _count2_carry(
            s2, jax.lax.slice_in_dim(pairs_t, c0,
                                     min(c0 + SCAN_CHUNK, W2)), state)
    abs_s = jnp.take(s2.all_p, state["rs"], axis=0) + state["os"]
    abs_e = jnp.take(s2.all_p, state["re"], axis=0) + state["oe"]
    started = state["matched"] > 0
    return state["matched"], jnp.where(started, abs_e - abs_s + 1, 0)


def _zml_pair_body(s2: FusedSearch2Index):
    sigma = s2.sigma

    def init_i(a):
        rec = _onehot_rows(s2.init_rec, jnp.maximum(a, 0) + 1)
        return rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3]

    def body(state, v):
        a1, a2 = _unpack_pair(v)
        l1 = a1 >= 0
        l2 = a2 >= 0
        a12 = jnp.maximum(a1, 0) * sigma + jnp.maximum(a2, 0)
        mid, fin, empty1, empty2 = fused2_bs_step(
            s2, state["rs"], state["os"], state["re"], state["oe"],
            a12, l1, l2)
        ok1 = state["have"] & ~empty1
        ml1 = jnp.where(ok1, state["ml"] + 1, 0)
        # step a2 off the restart interval when a1's extension failed:
        # a pure function of (a1, a2), precomputed (one-hot contraction)
        rst = _onehot_rows(s2.restart_rec, a12)
        okA = ok1 & ~empty2
        okB = ~ok1 & l1 & l2 & (rst[:, 4] == 0)
        ok2 = okA | okB
        ml2 = jnp.where(ok2, ml1 + 1, 0)
        ini2 = init_i(a2)
        new = dict(have=ok2 | l2, ml=ml2)
        for i, k in enumerate(_IKEYS):
            new[k] = jnp.where(okA, fin[i],
                               jnp.where(okB, rst[:, i], ini2[i]))
        return new, (ml1, ml2)
    return body


@jax.jit
def _zml2_carry(s2: FusedSearch2Index, pairs_t: jax.Array, state):
    return jax.lax.scan(_zml_pair_body(s2), state,
                        pairs_t.astype(jnp.int32))


def fused2_zml_scan(s2: FusedSearch2Index, pairs_t: jax.Array):
    """ZML (query_zml recurrence) over paired records; emissions are
    the match length AFTER each char, matching fused_zml_scan."""
    W2 = pairs_t.shape[0]
    lanes = pairs_t.shape[1]
    zero = jnp.zeros((lanes,), jnp.int32)
    state = dict(rs=zero, os=zero, re=zero, oe=zero,
                 have=jnp.zeros((lanes,), bool), ml=zero)
    emit_chunks = []
    for c0 in range(0, W2, SCAN_CHUNK):
        state, (ml1, ml2) = _zml2_carry(
            s2, jax.lax.slice_in_dim(pairs_t, c0,
                                     min(c0 + SCAN_CHUNK, W2)), state)
        n = ml1.shape[0]
        emit_chunks.append(
            jnp.stack([ml1, ml2], axis=1).reshape(2 * n, lanes))
    return jnp.concatenate(emit_chunks, axis=0)


def _pair_rows(ext: jnp.ndarray):
    """[E, nk] extension char rows -> ([P, nk], [P, nk]) row pairs,
    padding an odd tail with the beyond-read sentinel."""
    E = ext.shape[0]
    if E % 2:
        ext = jnp.concatenate(
            [ext, jnp.full((1, ext.shape[1]), -2, ext.dtype)])
    return ext[0::2], ext[1::2]


@partial(jax.jit, static_argnums=(2,))
def fused2_kmer_count_scan(s2: FusedSearch2Index, alphas: jax.Array,
                           k: int):
    """Exact-count kernel over paired records: one lane per k-mer, the
    k-1 backward extensions run as composed step PAIRS -- half the
    gathered rows of engine/fused_kmer.py's _kmer_count_scan, identical
    results.  alphas: int32 [k, nk] in k-mer order."""
    legal = jnp.all(alphas >= 0, axis=0)
    rec = jnp.take(s2.init_rec,
                   jnp.maximum(alphas[k - 1], 0) + 1, axis=0)
    state = dict(rs=rec[:, 0], os=rec[:, 1], re=rec[:, 2], oe=rec[:, 3],
                 dead=~legal)
    a1s, a2s = _pair_rows(alphas[:-1][::-1])

    def body(state, xs):
        a1, a2 = xs
        l2 = a2 >= 0
        mid, fin, e1, e2 = fused2_bs_step(
            s2, state["rs"], state["os"], state["re"], state["oe"],
            jnp.maximum(a1, 0) * s2.sigma + jnp.maximum(a2, 0),
            a1 >= 0, l2)
        alive = ~state["dead"]
        ok1 = alive & ~e1
        ok2 = ok1 & ~e2
        new = dict(dead=state["dead"] | (alive & (e1 | (l2 & ~e1 & e2))))
        for kk, m, f in zip(_IKEYS, mid, fin):
            new[kk] = jnp.where(ok2, f, jnp.where(ok1, m, state[kk]))
        return new, None

    state, _ = jax.lax.scan(body, state, (a1s, a2s))
    found = ~state["dead"] & legal
    cnt = (jnp.take(s2.all_p, state["re"], axis=0) + state["oe"]
           - jnp.take(s2.all_p, state["rs"], axis=0) - state["os"] + 1)
    return found, jnp.where(found, cnt, 0)


class Fused2KmerCountEngine:
    """Exact k-mer counts on the paired search records (one composed
    gather per two extensions).  Results identical to
    FusedKmerCountEngine / AdvancedEngine.count_kmers_bidirectional."""

    def __init__(self, s2: FusedSearch2Index, k: int):
        self.s2 = s2
        self.k = k

    def query_batch(self, batch: ReadBatch) -> List[Tuple[int, int]]:
        from .fused_kmer import batch_kmer_windows

        k = self.k
        al, own = batch_kmer_windows(batch, self.s2.alphamap_query, k)
        if al is None:
            return [(0, 0)] * batch.lanes
        found, cnt = fused2_kmer_count_scan(self.s2, jnp.asarray(al), k)
        found = np.asarray(found)
        cnt = np.asarray(cnt)
        f = np.zeros(batch.lanes, dtype=np.int64)
        t = np.zeros(batch.lanes, dtype=np.int64)
        np.add.at(f, own, found.astype(np.int64))
        np.add.at(t, own, cnt.astype(np.int64))
        return [(int(f[i]), int(t[i])) for i in range(batch.lanes)]


class Fused2CountEngine:
    """Count queries at one composed-record gather per base."""

    def __init__(self, s2: FusedSearch2Index):
        self.s2 = s2

    def query_batch(self, batch: ReadBatch) -> List[Tuple[int, int]]:
        alphas = self.s2.alphamap_query[batch.seqs[:, ::-1]]
        W = batch.width
        t_idx = np.arange(W)[None, :]
        alphas = np.where(t_idx >= batch.lengths[:, None], -2, alphas)
        a0 = jnp.asarray(alphas[:, 0].astype(np.int32))
        pairs, _ = pack_search_pairs(alphas[:, 1:], self.s2.sigma)
        matched, count = fused2_count_scan(self.s2, a0,
                                           jnp.asarray(pairs))
        matched = np.asarray(matched)
        count = np.asarray(count)
        return [(int(batch.lengths[i]) - int(matched[i]), int(count[i]))
                for i in range(batch.lanes)]


class Fused2ZMLEngine:
    """ZML at one composed-record gather per base."""

    def __init__(self, s2: FusedSearch2Index):
        self.s2 = s2

    def query_batch(self, batch: ReadBatch) -> List[List[int]]:
        alphas = self.s2.alphamap_query[batch.seqs[:, ::-1]]
        W = batch.width
        t_idx = np.arange(W)[None, :]
        alphas = np.where(t_idx >= batch.lengths[:, None], -2, alphas)
        pairs, _ = pack_search_pairs(alphas, self.s2.sigma)
        ml = np.asarray(fused2_zml_scan(self.s2, jnp.asarray(pairs)))
        return [ml[: int(batch.lengths[i]), i].tolist()
                for i in range(batch.lanes)]
