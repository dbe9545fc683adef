"""Dense PML automaton engine: ONE int32 gather per base.

The PML step (move_structure_query.cpp:234-361) is a deterministic function
of (BWT position p, read character a): case 1 jumps to LF(p); case 2
repositions via the threshold and then LFs; illegal characters just LF.
The engine with the fewest bytes per step stores that function as a
dense transition table:

    dense[p, a] = next_p  |  (is_match << 31)

so the whole per-base step is a single int32 gather plus two
elementwise ops.
Slot sigma handles illegal characters (plain LF, match_len = 0).

Memory cost is (sigma+1)*4 bytes per BWT position (~20 B/base for
DNA) -- a trade of device-memory capacity for random-access count.  For indexes too large for this table, the run-record engine
(engine/fused.py) and the compact engine (engine/pml.py) cover the
O(r)-space regime.

Bit-exactness: identical trajectories to ScalarEngine by construction
(the table is built by evaluating the reference semantics at every
position); verified in tests/test_fused.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List

import numpy as np

import jax
import jax.numpy as jnp

from .device_index import build_thr_full
from ..constants import SEPARATOR
from ..index.structure import MoveIndex
from ..io.fastx import ReadBatch

_MATCH_BIT = np.int64(1) << 31
_POS_MASK = (1 << 31) - 1


@dataclass
class DenseIndex:
    n: int
    sigma: int
    table: jax.Array            # int32 [n * (sigma+1)]
    start_pos: int              # n - 1
    alphamap_query: np.ndarray  # host-side byte -> slot


jax.tree_util.register_dataclass(
    DenseIndex,
    data_fields=["table", "alphamap_query"],
    meta_fields=["n", "sigma", "start_pos"],
)


def build_dense_index(ix: MoveIndex) -> DenseIndex:
    """Evaluate the PML step at every (position, char) -> transition table."""
    assert ix.thr is not None, "dense engine requires a thresholds mode"
    assert ix.length < 2**31
    r, sigma, n = ix.r, ix.sigma, ix.length
    n64 = ix.n_arr.astype(np.int64)
    all_p = ix.all_p
    lf_abs = all_p[ix.id_arr] + ix.offset_arr.astype(np.int64)

    thr_full = build_thr_full(ix)  # [r, sigma]
    nu, nd = ix.next_tables()      # '$' row matches alphabet[0] (reference)

    row_of_p = np.repeat(np.arange(r, dtype=np.int64), n64)
    off_of_p = np.arange(n, dtype=np.int64) - all_p[row_of_p]
    lf_of_p = lf_abs[row_of_p] + off_of_p  # LF in absolute position space

    slots = sigma + 1
    table = np.empty((n, slots), dtype=np.int32)
    table[:, sigma] = lf_of_p  # illegal char: plain LF, no match bit

    c_row = ix.c_arr.astype(np.int64)
    for a in range(sigma):
        # reposition targets per run (scan starts one row up/down)
        up = np.full(r, r, dtype=np.int64)
        dn = np.full(r, r, dtype=np.int64)
        up[1:] = nu[a, :-1]
        dn[:-1] = nd[a, 1:]
        up_c = np.minimum(up, r - 1)
        dn_c = np.minimum(dn, r - 1)
        up_dest = lf_abs[up_c] + n64[up_c] - 1  # (up_run, n-1) then LF
        dn_dest = lf_abs[dn_c]                  # (dn_run, 0) then LF

        is_match_row = c_row == a
        go_down = off_of_p >= thr_full[row_of_p, a]
        case2 = np.where(go_down, dn_dest[row_of_p], up_dest[row_of_p])
        nxt = np.where(is_match_row[row_of_p],
                       lf_of_p | _MATCH_BIT,
                       case2)
        table[:, a] = nxt.astype(np.int64).astype(np.int32)

    alphamap_query = np.full(256, sigma, dtype=np.int32)
    for a, ch in enumerate(ix.alphabet):
        alphamap_query[ch] = a
    if ix.separators:
        alphamap_query[SEPARATOR] = sigma

    return DenseIndex(
        n=n, sigma=sigma,
        table=jnp.asarray(table.reshape(-1)),
        start_pos=n - 1,
        alphamap_query=alphamap_query,
    )


@partial(jax.jit, donate_argnums=(1,))
def _dense_pml_scan(di: DenseIndex, alphas_t: jax.Array):
    """alphas_t: int32 [W, lanes] with values in [0, sigma]."""
    lanes = alphas_t.shape[1]
    slots = di.sigma + 1
    p0 = jnp.full((lanes,), di.start_pos, dtype=jnp.int32)
    ml0 = jnp.zeros((lanes,), dtype=jnp.int32)

    def step(state, a):
        p, ml = state
        w = jnp.take(di.table, p * slots + a, axis=0)
        is_match = w < 0
        new_ml = jnp.where(is_match, ml + 1, 0)
        new_p = w & _POS_MASK
        return (new_p, new_ml), new_ml

    _, ml = jax.lax.scan(step, (p0, ml0), alphas_t)
    return ml


class DensePMLEngine:
    def __init__(self, di: DenseIndex):
        self.di = di

    def query_batch_device(self, batch: ReadBatch) -> jax.Array:
        seqs_rev = batch.seqs[:, ::-1]
        alphas = self.di.alphamap_query[seqs_rev]
        return _dense_pml_scan(self.di, jnp.asarray(alphas.T.astype(np.int32)))

    def query_batch(self, batch: ReadBatch) -> List[List[int]]:
        ml = np.asarray(self.query_batch_device(batch))
        return [ml[: int(batch.lengths[i]), i].tolist()
                for i in range(batch.lanes)]
