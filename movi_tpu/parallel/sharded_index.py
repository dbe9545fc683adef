"""Index-sharded (capacity-scaling) PML engine.

When the index exceeds one card's memory, the fused record table is
sharded across a second mesh axis ('model'); read lanes stay
data-parallel on 'data'.  Each scan step, every model shard gathers with
the lane's global key clamped into its local range, masks non-owned
lanes to zero, and a psum over 'model' materializes the full record --
one local gather plus one small all-reduce per step, which XLA hands to
NCCL over NVLink.  The cards of a host are joined all to all, so the
mesh shape follows the algorithm, not a wiring topology.  This is the
"index sharded by run range with collective routing" design of SURVEY.md
section 5 (the reference is single-node and has no equivalent).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from ..engine.fused import FusedIndex, fused_step_math


def make_2d_mesh(data: int, model: int) -> Mesh:
    devs = np.array(jax.devices()[: data * model]).reshape(data, model)
    return Mesh(devs, ("data", "model"))


def _pad_records(records: np.ndarray, model: int) -> np.ndarray:
    rows = records.shape[0]
    pad = (-rows) % model
    if pad:
        records = np.concatenate(
            [records, np.zeros((pad, records.shape[1]), records.dtype)])
    return records


def sharded_fused_pml(mesh: Mesh, fi: FusedIndex, alphas_t: np.ndarray):
    """alphas_t: int32 [W, lanes] (slot sigma = illegal).  Returns
    ml [W, lanes] computed with the record table sharded over 'model'."""
    model = mesh.shape["model"]
    records = _pad_records(np.asarray(fi.records), model)
    shard_len = records.shape[0] // model
    slots = fi.sigma + 1
    start_idx, start_off = fi.start_idx, fi.start_offset
    p_dollar = fi.p_dollar

    rec_sharding = NamedSharding(mesh, P("model", None))
    lane_sharding = NamedSharding(mesh, P(None, "data"))
    records_d = jax.device_put(jnp.asarray(records), rec_sharding)
    alphas_d = jax.device_put(jnp.asarray(alphas_t), lane_sharding)

    @partial(shard_map, mesh=mesh,
             in_specs=(P("model", None), P(None, "data")),
             out_specs=P(None, "data"))
    def run(local_records, alphas):
        my_shard = jax.lax.axis_index("model")
        lo = my_shard * shard_len
        # derive the carry from alphas so it is marked varying over 'data'
        idx0 = jnp.full_like(alphas[0], start_idx)
        off0 = jnp.full_like(alphas[0], start_off)
        ml0 = jnp.zeros_like(alphas[0])

        def step(state, a):
            idx, offset, ml = state
            key = idx * slots + a
            local = key - lo
            owned = (local >= 0) & (local < shard_len)
            rec = jnp.take(local_records,
                           jnp.clip(local, 0, shard_len - 1), axis=0)
            rec = jnp.where(owned[:, None], rec, 0)
            rec = jax.lax.psum(rec, "model")
            return fused_step_math(rec, state, p_dollar)

        _, ml = jax.lax.scan(step, (idx0, off0, ml0), alphas)
        return ml

    return run(records_d, alphas_d)


from ..engine.fused_search import _lf_from_rec  # noqa: E402


def _sharded_search_scan(mesh: Mesh, si, alphas_t: np.ndarray, kind: str):
    """Backward-search scan (count or ZML) with the one-step search
    records (engine/fused_search.py rec_all, 32 B/run/char) sharded over
    'model': each step's 2*lanes-key gather runs locally per shard,
    non-owned rows zero, one psum materializes the records.  Capacity
    scales by the model axis; read lanes stay data-parallel."""
    model = mesh.shape["model"]
    records = _pad_records(np.asarray(si.rec_all), model)
    shard_len = records.shape[0] // model
    r, sigma = si.r, si.sigma
    init_rec = jnp.asarray(np.asarray(si.init_rec))  # tiny: replicated

    rec_sharding = NamedSharding(mesh, P("model", None))
    lane_sharding = NamedSharding(mesh, P(None, "data"))
    records_d = jax.device_put(jnp.asarray(records), rec_sharding)
    alphas_d = jax.device_put(jnp.asarray(alphas_t), lane_sharding)

    @partial(shard_map, mesh=mesh,
             in_specs=(P("model", None), P(None, "data")),
             out_specs=P(None, "data"))
    def run(local_records, alphas):
        my_shard = jax.lax.axis_index("model")
        lo = my_shard * shard_len
        lanes = alphas.shape[1]

        def gather_both(rs, re, a):
            a_s = jnp.maximum(a, 0)
            keys = jnp.concatenate([
                a_s * r + jnp.minimum(rs, r - 1),
                sigma * r + a_s * r + jnp.minimum(re, r - 1)])
            local = keys - lo
            owned = (local >= 0) & (local < shard_len)
            rec = jnp.take(local_records,
                           jnp.clip(local, 0, shard_len - 1), axis=0)
            rec = jnp.where(owned[:, None], rec, 0)
            return jax.lax.psum(rec, "model")

        def bs_step(rs, os_, re, oe, a):
            both = gather_both(rs, re, a)
            rd, ru = both[:lanes], both[lanes:]
            drs = rd[:, 0]
            dre = ru[:, 0]
            empty = (a < 0) | (drs >= r) | (drs > re)
            os1 = jnp.where(drs != rs, 0, os_)
            oe1 = jnp.where(dre != re, ru[:, 3] - 1, oe)
            nrs, nos = _lf_from_rec(rd, os1)
            nre, noe = _lf_from_rec(ru, oe1)
            return nrs, nos, nre, noe, empty

        def init_oh(a):
            nrows = init_rec.shape[0]
            idx = jnp.maximum(a, 0) + 1
            oh = idx[:, None] == jnp.arange(nrows, dtype=idx.dtype)[None, :]
            rec = jnp.sum(jnp.where(oh[:, :, None], init_rec[None], 0),
                          axis=1)
            return rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3]

        a0 = alphas[0]
        legal0 = a0 >= 0
        rs, os_, re, oe = init_oh(a0)
        if kind == "count":
            state = dict(rs=rs, os=os_, re=re, oe=oe, done=~legal0,
                         matched=jnp.where(legal0, 1, 0).astype(jnp.int32),
                         prs=rs, pos_=os_, pre=re, poe=oe)

            def body(state, a):
                alive = ~state["done"]
                nrs, nos, nre, noe, empty = bs_step(
                    state["rs"], state["os"], state["re"], state["oe"], a)
                ok = alive & ~empty
                new = dict(state)
                for cur, prev, v in zip(
                        ("rs", "os", "re", "oe"),
                        ("prs", "pos_", "pre", "poe"),
                        (nrs, nos, nre, noe)):
                    new[cur] = jnp.where(ok, v, state[cur])
                    new[prev] = jnp.where(ok, v, state[prev])
                new["matched"] = state["matched"] + ok.astype(jnp.int32)
                new["done"] = state["done"] | (alive & empty)
                return new, None

            state, _ = jax.lax.scan(body, state, alphas[1:])
            return jnp.stack([state["matched"], state["prs"],
                              state["pos_"], state["pre"], state["poe"]])
        else:  # zml
            # zeros_like(a0) keeps the carry varying over 'data'
            state = dict(rs=rs, os=os_, re=re, oe=oe, have=legal0,
                         ml=jnp.zeros_like(a0))

            def body(state, a_next):
                emit = jnp.where(state["have"], state["ml"], 0)
                nrs, nos, nre, noe, empty = bs_step(
                    state["rs"], state["os"], state["re"], state["oe"],
                    a_next)
                ext_ok = state["have"] & ~empty
                irs, ios, ire, ioe = init_oh(a_next)
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

            state, emits = jax.lax.scan(body, state, alphas[1:])
            last = jnp.where(state["have"], state["ml"], 0)
            return jnp.concatenate([emits, last[None, :]], axis=0)

    return run(records_d, alphas_d)


def sharded_fused_count(mesh: Mesh, si, alphas_t: np.ndarray):
    """Count query with the record table sharded over 'model'.
    alphas_t: int32 [W, lanes] (-1 illegal, -2 beyond read); returns
    (matched, count) like engine/fused_search.fused_count_scan."""
    out = _sharded_search_scan(mesh, si, alphas_t, "count")
    matched, prs, pos_, pre, poe = (out[i] for i in range(5))
    all_p = jnp.asarray(np.asarray(si.all_p))
    abs_s = jnp.take(all_p, prs, axis=0) + pos_
    abs_e = jnp.take(all_p, pre, axis=0) + poe
    started = matched > 0
    return matched, jnp.where(started, abs_e - abs_s + 1, 0)


def sharded_fused_zml(mesh: Mesh, si, alphas_t: np.ndarray):
    """ZML with the record table sharded over 'model'; emissions match
    engine/fused_search.fused_zml_scan."""
    return _sharded_search_scan(mesh, si, alphas_t, "zml")
