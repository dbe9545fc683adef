"""Multi-chip / multi-host scaling.

The reference parallelizes with OpenMP threads over a shared BatchLoader
(movi.cpp:274-301).  The device equivalent is data parallelism over the
read lane axis of a jax.sharding.Mesh:

  - index tables are replicated per device (resident in device memory)
  - read batches are sharded on the lane axis; every device runs the same
    fused gather-scan on its shard -- no collectives in the query loop
  - aggregate statistics (total ff counts, kmer stats, found-read counts)
    merge via psum-style reductions at batch end
  - multi-host: the same code under jax.distributed; batches stream
    data-parallel per host (SURVEY.md section 5)

A character-sharded index layout (all-to-all routing of lane->shard steps)
is the planned capacity-scaling variant for indexes exceeding one card's
memory.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.fused import FusedIndex, fused_pml_step


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def replicate_index(mesh: Mesh, fi: FusedIndex) -> FusedIndex:
    rep = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, rep), fi)


@partial(jax.jit, static_argnums=(3,))
def _pml_classify_scan(fi: FusedIndex, alphas_t: jax.Array,
                       lengths: jax.Array, bin_width: int,
                       max_value_thr: jax.Array):
    """Fused PML + on-device classification.

    Returns (ml [W, lanes] u16, found [lanes] bool, above, below [lanes]).
    Classification mirrors classifier.cpp:99-143: bins over the
    processing-order matching lengths, last short region merged into the
    previous bin.
    """
    W, lanes = alphas_t.shape
    slots = fi.sigma + 1
    idx0 = jnp.full((lanes,), fi.start_idx, jnp.int32)
    off0 = jnp.full((lanes,), fi.start_offset, jnp.int32)
    ml0 = jnp.zeros((lanes,), jnp.int32)

    def step(state, a):
        return fused_pml_step(fi.records, slots, fi.p_dollar, state, a)

    _, ml = jax.lax.scan(step, (idx0, off0, ml0), alphas_t)
    found, above, below = _classify_from_ml(ml, lengths, bin_width,
                                            max_value_thr)
    return ml.astype(jnp.uint16), found, above, below


def _classify_from_ml(ml: jax.Array, lengths: jax.Array, bin_width: int,
                      max_value_thr: jax.Array):
    """Binned maxima + threshold vote, vectorized over variable read
    lengths (classifier.cpp:99-143; last short region merged into the
    previous bin)."""
    W, lanes = ml.shape
    nb = -(-W // bin_width)  # naive bin count (ceil)
    pad = nb * bin_width - W
    t_idx = jnp.arange(W)[:, None]
    masked = jnp.where(t_idx < lengths[None, :], ml, -1)
    padded = jnp.pad(masked, ((0, pad), (0, 0)), constant_values=-1)
    naive = padded.reshape(nb, bin_width, lanes).max(axis=1)  # [nb, lanes]

    B = jnp.maximum(lengths // bin_width, 1)  # true bin count per lane
    b_idx = jnp.arange(nb)[:, None]
    # bins strictly before the merged last bin
    pre = (b_idx < B[None, :] - 1) & (naive >= max_value_thr)
    above_pre = pre.sum(axis=0)
    # merged last bin: max over naive bins B-1 .. nb-1
    tailmask = b_idx >= (B[None, :] - 1)
    tail_max = jnp.where(tailmask, naive, -1).max(axis=0)
    above = above_pre + (tail_max >= max_value_thr).astype(jnp.int32)
    below = B.astype(jnp.int32) - above
    found = 2 * above > B
    return found, above, below


@partial(jax.jit, static_argnums=(3, 5))
def _pml_classify_scan_paired(f2, a12_t: jax.Array, lengths: jax.Array,
                              bin_width: int, max_value_thr: jax.Array,
                              W: int):
    """Paired-record variant (engine/fused2.py): one 16 B gather per two
    bases, same on-device classification."""
    from ..engine.fused2 import fused2_step

    W2, lanes = a12_t.shape
    slots = f2.sigma + 1
    a12_t = a12_t.astype(jnp.int32)
    state = (jnp.full((lanes,), f2.start_idx, jnp.int32),
             jnp.full((lanes,), f2.start_offset, jnp.int32),
             jnp.zeros((lanes,), jnp.int32))

    def step(st, a):
        return fused2_step(f2.records, slots, f2.p_dollar, st, a)

    _, (ml1, ml2) = jax.lax.scan(step, state, a12_t)
    ml = jnp.stack([ml1, ml2], axis=1).reshape(2 * W2, lanes)[:W]
    found, above, below = _classify_from_ml(ml, lengths, bin_width,
                                            max_value_thr)
    return ml.astype(jnp.uint16), found, above, below


class ShardedSearchEngine:
    """Data-parallel count / ZML queries over a mesh: the search
    records (one-step, or the paired composed layout) replicated per
    device, read lanes sharded (the same layout as ShardedPMLEngine; no
    collectives in the query loop)."""

    def __init__(self, si, mesh: Optional[Mesh] = None,
                 paired: bool = False):
        self.mesh = mesh or make_mesh()
        rep = NamedSharding(self.mesh, P())
        self.paired = paired
        self.si = jax.tree.map(lambda a: jax.device_put(a, rep), si)
        self.lane_sharding = NamedSharding(self.mesh, P(None, "data"))
        self.vec_sharding = NamedSharding(self.mesh, P("data"))

    def _alphas_np(self, seqs: np.ndarray, lengths: np.ndarray):
        alphas = np.asarray(self.si.alphamap_query)[
            seqs[:, ::-1]].astype(np.int32)
        t_idx = np.arange(seqs.shape[1])[None, :]
        return np.where(t_idx >= lengths[:, None], -2, alphas)

    def _alphas(self, seqs: np.ndarray, lengths: np.ndarray):
        return jax.device_put(
            jnp.asarray(self._alphas_np(seqs, lengths).T),
            self.lane_sharding)

    def count_batch_device(self, seqs: np.ndarray, lengths: np.ndarray):
        if self.paired:
            from ..engine.fused_search2 import (fused2_count_scan,
                                                pack_search_pairs)

            alphas = self._alphas_np(seqs, lengths)
            a0 = jax.device_put(
                jnp.asarray(alphas[:, 0].astype(np.int32)),
                self.vec_sharding)
            pairs, _ = pack_search_pairs(alphas[:, 1:], self.si.sigma)
            pairs_d = jax.device_put(jnp.asarray(pairs),
                                     self.lane_sharding)
            return fused2_count_scan(self.si, a0, pairs_d)
        from ..engine.fused_search import fused_count_scan

        return fused_count_scan(self.si, self._alphas(seqs, lengths))

    def zml_batch_device(self, seqs: np.ndarray, lengths: np.ndarray):
        if self.paired:
            from ..engine.fused_search2 import (fused2_zml_scan,
                                                pack_search_pairs)

            pairs, _ = pack_search_pairs(
                self._alphas_np(seqs, lengths), self.si.sigma)
            pairs_d = jax.device_put(jnp.asarray(pairs),
                                     self.lane_sharding)
            return fused2_zml_scan(self.si, pairs_d)
        from ..engine.fused_search import fused_zml_scan

        return fused_zml_scan(self.si, self._alphas(seqs, lengths))


class ShardedColorEngine:
    """Data-parallel Movi Color scan over a mesh: index + color ids
    replicated, lanes sharded; the host vote tally happens per shard
    after gathering (engine/fused_color.py)."""

    def __init__(self, ci, mesh: Optional[Mesh] = None):
        self.mesh = mesh or make_mesh()
        rep = NamedSharding(self.mesh, P())
        self.ci = jax.tree.map(lambda a: jax.device_put(a, rep), ci)
        self.lane_sharding = NamedSharding(self.mesh, P(None, "data"))

    def query_batch_device(self, seqs: np.ndarray):
        from ..engine.fused_color import _fused_color_scan

        alphas = np.asarray(self.ci.fi.alphamap_query)[
            seqs[:, ::-1]].T.astype(np.uint8)
        alphas_d = jax.device_put(jnp.asarray(alphas), self.lane_sharding)
        return _fused_color_scan(self.ci, alphas_d)


class ShardedKmerEngine:
    """Data-parallel exact k-mer counts over a mesh: search records
    replicated, one device lane per k-mer window, windows sharded on
    'data' (the reference gives kmer search the full latency-hiding
    runtime, read_processor.cpp:1096-1175; here the lanes ARE the
    latency hiding)."""

    def __init__(self, si, k: int, mesh: Optional[Mesh] = None):
        self.mesh = mesh or make_mesh()
        rep = NamedSharding(self.mesh, P())
        self.si = jax.tree.map(lambda a: jax.device_put(a, rep), si)
        self.k = k

    def count_windows_device(self, windows: np.ndarray):
        """windows: int32 [k, nk] alphabet slots in k-mer order; nk
        must divide by the mesh size (pad with illegal -1 columns).
        Returns (found, count) [nk] device arrays sharded on 'data'."""
        from ..engine.fused_kmer import _kmer_count_scan

        al = jax.device_put(jnp.asarray(windows),
                            NamedSharding(self.mesh, P(None, "data")))
        return _kmer_count_scan(self.si, al, self.k)


class ShardedMemEngine:
    """Data-parallel MEM finding over a mesh: bidirectional index
    replicated, read lanes sharded; the lockstep tick state machine
    (engine/fused_mem.py) runs unchanged per shard."""

    def __init__(self, mi, min_mem_length: int = 0,
                 mesh: Optional[Mesh] = None):
        self.mesh = mesh or make_mesh()
        rep = NamedSharding(self.mesh, P())
        self.mi = jax.tree.map(lambda a: jax.device_put(a, rep), mi)
        self.L = min_mem_length

    def query_batch_device(self, seqs: np.ndarray, lengths: np.ndarray):
        """seqs: uint8 [lanes, W] right-aligned (lanes divisible by the
        mesh size).  Returns state dict with ends/counts [lanes, W]
        sharded on 'data'."""
        from ..engine.fused_mem import (_all_mem_scan, _mem_scan,
                                        make_mem_state)

        si = self.mi.si
        lanes, W = seqs.shape
        alphas = np.full((lanes, W), -2, dtype=np.int32)
        amap = np.asarray(si.alphamap_query).copy()
        amap[ord("#")] = -3
        for i in range(lanes):
            Li = int(lengths[i])
            alphas[i, :Li] = amap[
                np.frombuffer(seqs[i, W - Li:].tobytes(), np.uint8)]
        lane_sh = NamedSharding(self.mesh, P("data", None))
        al = jax.device_put(jnp.asarray(alphas), lane_sh)
        lens_d = jax.device_put(jnp.asarray(lengths.astype(np.int32)),
                                NamedSharding(self.mesh, P("data")))
        ticks = 4 * W + 64
        if self.L >= 2:
            state = make_mem_state(lanes, W, lens_d, self.L)
            for _ in range(W):
                state, d = _mem_scan(self.mi, al, state, self.L, ticks)
                if bool(d):
                    return state
        else:
            state = _sharded_all_mem_state(self.mi, al, lens_d, lanes, W)
            for _ in range(W):
                state, d = _all_mem_scan(self.mi, al, ticks, state)
                if bool(d):
                    return state
        raise AssertionError("MEM scan did not converge")


@partial(jax.jit, static_argnums=(3, 4))
def _sharded_all_mem_state(mi, al, lengths, lanes: int, W: int):
    """all-MEMs entry state (FusedAllMemEngine.make_state) jitted so
    sharding propagates from the lane-sharded inputs."""
    from ..engine.fused_mem import AM_DONE, AM_RIGHT
    from ..engine.fused_search import _init_interval

    si = mi.si
    sigma = si.sigma
    z = jnp.zeros((lanes,), jnp.int32)
    c0 = al[:, 0]
    i_frs, i_fos, i_fre, i_foe = _init_interval(si, c0)
    legal = c0 >= 0
    c0r = jnp.where(legal, sigma - 1 - c0, jnp.where(c0 == -1, 0, -1))
    i_rrs, i_ros, i_rre, i_roe = _init_interval(si, c0r)
    rlegal = c0r >= 0
    return dict(
        phase=jnp.where(lengths > 0, AM_RIGHT, AM_DONE).astype(jnp.int32),
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


class ShardedPMLEngine:
    """Data-parallel PML (+classification) over a mesh."""

    def __init__(self, fi: FusedIndex, mesh: Optional[Mesh] = None,
                 bin_width: int = 150, max_value_thr: int = 4,
                 paired: bool = False):
        self.mesh = mesh or make_mesh()
        self.bin_width = bin_width
        self.max_value_thr = max_value_thr
        self.lane_sharding = NamedSharding(self.mesh, P(None, "data"))
        self.vec_sharding = NamedSharding(self.mesh, P("data"))
        self.paired = paired
        if paired:
            from ..engine.fused2 import build_fused2_index

            f2 = build_fused2_index(fi)
            self.fi = replicate_index(self.mesh, f2)
            self.alphamap_query = f2.alphamap_query
        else:
            self.fi = replicate_index(self.mesh, fi)
            self.alphamap_query = fi.alphamap_query

    def query_batch_device(self, seqs: np.ndarray, lengths: np.ndarray):
        """seqs: uint8 [lanes, W] right-aligned; lanes must be divisible
        by the mesh size.  Returns (ml, found, above, below) device arrays
        sharded over lanes."""
        lengths_d = jax.device_put(jnp.asarray(lengths.astype(np.int32)),
                                   self.vec_sharding)
        if self.paired:
            from ..engine.fused2 import pack_pairs

            fi = self.fi
            a12, W = pack_pairs(self.alphamap_query[seqs[:, ::-1]],
                                fi.sigma)
            a12_d = jax.device_put(jnp.asarray(a12), self.lane_sharding)
            return _pml_classify_scan_paired(
                fi, a12_d, lengths_d, self.bin_width,
                jnp.int32(self.max_value_thr), W)
        alphas = self.alphamap_query[seqs[:, ::-1]].T.astype(np.int32)
        alphas_d = jax.device_put(jnp.asarray(alphas), self.lane_sharding)
        return _pml_classify_scan(self.fi, alphas_d, lengths_d,
                                  self.bin_width,
                                  jnp.int32(self.max_value_thr))
