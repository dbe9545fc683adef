"""Exact k-mer counting v2: the reference's bidirectional k/2 cache
(query_kmers_from_bidirectional, sequitur.cpp:14-255) restructured as
straight-line device scans.

The v1 engines re-extend every window from scratch: k-1 extensions per
k-mer (fused_kmer._kmer_count_scan; paired halves the gathers).  The
reference amortizes overlapping windows: ONE bidirectional chain per
block of p = k/2 consecutive window ends, anchored at the rightmost
window's left end, extends RIGHT once across the block, caching each
prefix interval past the midpoint; every cached partial then pays only
its own LEFT extensions (depth d = 1..p-1).  Work per k-mer drops from
k-1 to ~(k-1)/p + (p-1)/2 extensions.

Device shape (no tick machine -- per-tick one-hot bookkeeping is paid
on every tick, so straight-line scans do less work):

  - lanes = GROUPS.  Phase R is one `lax.scan` of k-1 uniform
    extend_right steps on the MEM-v2 wide records (engine/fused_mem2):
    one 2-row gather per step, the fw interval carried purely in
    ABSOLUTE coordinates (skip and abs come embedded in the record).
    Partial intervals are the scan's emissions -- free.
  - Phase L runs per DEPTH BUCKET d: all groups' depth-d partials
    (host-compacted to the ALIVE ones -- dead partials cost nothing,
    the device analogue of the reference's skipping) resolve abs ->
    (run, offset) once via the records table's pos2rba rows, then run
    ceil(d/2) composed PAIRED extensions (engine/fused_search2) --
    1 gathered row per extension.

Counts are identical to the per-window definition for ANY p (each
block's windows are counted exactly once; a dead chain at j kills
exactly the windows containing j).  Bit-exact vs
AdvancedEngine.count_kmers_bidirectional (tests/test_fused_kmer2.py).
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .fused_mem2 import (FusedMem2Index, _init6, mem2_resolve, mem2_step)
from .fused_search2 import FusedSearch2Index, _IKEYS, fused2_bs_step
from ..io.fastx import ReadBatch


def _pow2(x: int, lo: int = 256) -> int:
    return max(lo, 1 << int(np.ceil(np.log2(max(x, 1)))))


@partial(jax.jit, static_argnums=(2,))
def _kmer2_right_scan(m2: FusedMem2Index, rchars: jax.Array, k: int):
    """Phase R: per group, init at rchars[0] and extend_right with
    rchars[1..k-1].  Returns (alive [k-1, G], fw_abs_s, fw_abs_e)."""
    sigma = m2.sigma
    a0 = rchars[0]
    i_f = _init6(m2, a0)
    a0r = jnp.where(a0 >= 0, sigma - 1 - a0, -1)
    i_r = _init6(m2, a0r)
    alive0 = a0 >= 0
    st0 = dict(rrs=i_r[0], ros=i_r[1], rre=i_r[2], roe=i_r[3],
               fas=i_f[4], fae=i_f[5], alive=alive0)

    def step(st, c):
        a = jnp.where(c >= 0, sigma - 1 - c, -1)
        nrs, nos, nre, noe, nas, nae, skip, empty = mem2_step(
            m2, st["rrs"], st["ros"], st["rre"], st["roe"], a)
        ok = st["alive"] & ~empty
        fas2 = jnp.where(ok, st["fas"] + skip, st["fas"])
        fae2 = fas2 + jnp.where(ok, nae - nas, st["fae"] - st["fas"])
        new = dict(rrs=jnp.where(ok, nrs, st["rrs"]),
                   ros=jnp.where(ok, nos, st["ros"]),
                   rre=jnp.where(ok, nre, st["rre"]),
                   roe=jnp.where(ok, noe, st["roe"]),
                   fas=fas2, fae=fae2, alive=ok)
        return new, (ok, fas2, fae2)

    _, (alives, fs, fe) = jax.lax.scan(step, st0, rchars[1:])
    return alives, fs, fe


@partial(jax.jit, static_argnums=(9,))
def _kmer2_left_flat(m2: FusedMem2Index, s2: FusedSearch2Index,
                     fsd, fed, al, lane_own, lane_anchor, lane_depth,
                     flat_idx, S: int):
    """Phase L, ALL depths in ONE call: lanes are the alive partials of
    every depth (plus the depth-0 full-right windows).  Per-lane char
    streams are derived ON DEVICE from the read slot matrix `al`
    (gathers from a small table, instead of shipping [S, M] char
    arrays from the host), padded with
    the -2 no-op sentinel past each lane's depth.  The partial abs
    intervals come from the device-resident phase-R emissions; returns
    per-lane (found, count) for host aggregation by owner.  Pad lanes
    carry depth -1 (dead from the start)."""
    W = al.shape[1]
    abs_s = jnp.take(fsd.ravel(), flat_idx, axis=0)
    abs_e = jnp.take(fed.ravel(), flat_idx, axis=0)
    rs, os_ = mem2_resolve(m2, abs_s)
    re, oe = mem2_resolve(m2, abs_e)
    state = dict(rs=rs, os=os_, re=re, oe=oe, dead=lane_depth < 0)
    alf = al.ravel()

    def char_j(j):
        col = lane_anchor - 1 - j
        c = jnp.take(alf, lane_own * W + jnp.clip(col, 0, W - 1),
                     axis=0)
        return jnp.where((j < lane_depth) & (col >= 0), c, -2)

    def body(state, jp):
        a1 = char_j(2 * jp)
        a2 = char_j(2 * jp + 1)
        l2 = a2 >= 0
        # -2 is the PAD sentinel (no-op: a lane whose depth is shorter
        # than the flat stream just coasts); -1 is a genuine illegal
        # read char, which must KILL the window (unlike the per-window
        # engines, lanes here are not pre-filtered for legality)
        pad1 = a1 == -2
        kill2 = a2 == -1
        mid, fin, e1, e2 = fused2_bs_step(
            s2, state["rs"], state["os"], state["re"], state["oe"],
            jnp.maximum(a1, 0) * s2.sigma + jnp.maximum(a2, 0),
            a1 >= 0, l2)
        alive = ~state["dead"]
        ok1 = alive & ~e1 & ~pad1
        ok2 = ok1 & ~e2
        new = dict(dead=state["dead"]
                   | (alive & ((~pad1 & e1) | (l2 & ~e1 & e2)
                               | (~e1 & kill2))))
        for kk, m, f in zip(_IKEYS, mid, fin):
            new[kk] = jnp.where(ok2, f, jnp.where(ok1, m, state[kk]))
        return new, None

    state, _ = jax.lax.scan(body, state, jnp.arange(S))
    found = ~state["dead"]
    cnt = (jnp.take(s2.all_p, state["re"], axis=0) + state["oe"]
           - jnp.take(s2.all_p, state["rs"], axis=0) - state["os"] + 1)
    return found, jnp.where(found, cnt, 0)


class FusedKmer2CountEngine:
    """Exact per-read k-mer (found, total) on the bidirectional-cache
    scheme.  Results identical to FusedKmerCountEngine /
    AdvancedEngine.count_kmers_bidirectional."""

    def __init__(self, m2: FusedMem2Index, s2: FusedSearch2Index,
                 k: int, p: int = 0):
        assert k >= 2
        self.m2 = m2
        self.s2 = s2
        self.k = k
        # block size: k/2 mirrors the reference; any p gives identical
        # counts (it only moves work between the shared right chain and
        # the per-window left chains)
        self.p = min(p or k // 2, k - 1) or 1

    def query_batch(self, batch: ReadBatch) -> List[Tuple[int, int]]:
        from ..io.fastx import left_aligned_slots

        k, p = self.k, self.p
        m2 = self.m2
        al = left_aligned_slots(batch, m2.alphamap_query, fill=-1)
        lens = batch.lengths.astype(np.int64)
        nw = np.maximum(lens - k + 1, 0)
        ng = -(-nw // p)  # groups per read
        f_out = np.zeros(batch.lanes, dtype=np.int64)
        t_out = np.zeros(batch.lanes, dtype=np.int64)
        G = int(ng.sum())
        if G == 0:
            return [(0, 0)] * batch.lanes

        own = np.repeat(np.arange(batch.lanes), ng)
        gi = np.concatenate([np.arange(x) for x in ng]).astype(np.int64)
        e = lens[own] - 1 - gi * p            # rightmost end per group
        anchor = e - k + 1
        p_eff = np.minimum(p, e - k + 2)      # windows in the block

        Gp = _pow2(G)
        # ship the chain chars as int8 (a quarter of the upload), widen
        # once on device
        rchars = np.full((k, Gp), -1, dtype=np.int8)
        cols = anchor[:, None] + np.arange(k)[None, :]
        rchars[:, :G] = al[own[:, None], cols].T
        alives_d, fsd, fed = _kmer2_right_scan(
            m2, jnp.asarray(rchars).astype(jnp.int32), k)
        al_d = jnp.asarray(al.astype(np.int8)).astype(jnp.int32)
        # only the relevant alive-flag rows cross back to the host; the
        # partial abs intervals stay device-resident
        rows_used = [k - 2 - d for d in range(0, p)]
        alives = np.asarray(alives_d[jnp.asarray(rows_used)])[:, :G]

        # flatten depth-0 (the full-right window) and every alive
        # partial into one lane set
        ds = np.arange(0, p)[:, None]                      # depth
        rows = k - 2 - ds
        mask = alives & (ds <= p_eff[None, :] - 1)
        mask[0] = alives[0]                                # depth 0
        dd, gg = np.nonzero(mask)
        if len(dd):
            M = _pow2(len(dd))
            flat_idx = np.zeros(M, dtype=np.int32)
            flat_idx[: len(dd)] = rows[dd, 0] * Gp + gg
            lane_own = np.zeros(M, dtype=np.int32)
            lane_own[: len(dd)] = own[gg]
            lane_anchor = np.zeros(M, dtype=np.int32)
            lane_anchor[: len(dd)] = anchor[gg]
            lane_depth = np.full(M, -1, dtype=np.int32)
            lane_depth[: len(dd)] = dd
            S = (p - 1 + 1) // 2 if p > 1 else 1
            found, cnt = _kmer2_left_flat(
                m2, self.s2, fsd, fed, al_d,
                jnp.asarray(lane_own), jnp.asarray(lane_anchor),
                jnp.asarray(lane_depth), jnp.asarray(flat_idx), S)
            found = np.asarray(found)[: len(dd)]
            cnt = np.asarray(cnt)[: len(dd)]
            np.add.at(f_out, own[gg][found], 1)
            np.add.at(t_out, own[gg][found], cnt[found])

        return [(int(f_out[i]), int(t_out[i]))
                for i in range(batch.lanes)]
