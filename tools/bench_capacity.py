#!/usr/bin/env python
"""Capacity-ladder measurement: replicated vs model-sharded PML on the
virtual 8-device CPU mesh (the sharding testbed; jax.sharding semantics
are identical across the cards of a GPU host, only the interconnect
differs).  Times from this script are CPU times, not device times.

Measures, on the SAME mesh and batch:
  - data-parallel replicated-index rate (parallel/mesh.py)
  - model-sharded record table rate (parallel/sharded_index.py), i.e.
    the capacity mode for indexes exceeding one card's memory: one local
    gather into the 1/M-size shard + one psum of the selected 8-byte
    record per step
and verifies both bit-equal to the single-device fused engine.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python tools/bench_capacity.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from movi_tpu.build.suffix import build_bwt_runs
    from movi_tpu.engine.fused import FusedPMLEngine, build_fused_index
    from movi_tpu.index.structure import build_move_index
    from movi_tpu.parallel.mesh import ShardedPMLEngine, make_mesh
    from movi_tpu.parallel.sharded_index import (make_2d_mesh,
                                                 sharded_fused_pml)

    n_dev = len(jax.devices())
    print(f"devices: {n_dev}")
    rng = np.random.default_rng(0)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=400_000)
    ix = build_move_index(build_bwt_runs(text), "regular-thresholds",
                          bound_ff=1)
    fi = build_fused_index(ix)
    print(f"r = {ix.r}, fused table {np.asarray(fi.records).nbytes/1e6:.1f} MB")

    LANES, W = 1024, 150
    starts = rng.integers(0, len(text) - W, size=LANES)
    reads = np.stack([text[s:s + W] for s in starts])
    alphas = fi.alphamap_query[reads[:, ::-1]].T.astype(np.int32)

    # ground truth
    ml_ref = np.asarray(FusedPMLEngine(fi).query_batch_device(
        type("B", (), dict(seqs=reads, lanes=LANES, width=W,
                           lengths=np.full(LANES, W),
                           names=[str(i) for i in range(LANES)]))()))

    def timeit(fn, reps=5):
        fn()  # compile + warm
        t0 = time.time()
        for _ in range(reps):
            np.asarray(fn())
        return LANES * W * reps / (time.time() - t0)

    # replicated data-parallel (throughput mode)
    mesh1 = make_mesh(n_dev)
    eng = ShardedPMLEngine(fi, mesh=mesh1)
    lengths = np.full(LANES, W)

    def run_rep():
        ml, *_ = eng.query_batch_device(reads, lengths)
        return ml

    ml_rep = np.asarray(run_rep())[:W]
    assert np.array_equal(ml_rep, ml_ref), "replicated mismatch"
    rate_rep = timeit(run_rep)
    print(f"replicated data={n_dev}: {rate_rep/1e6:.1f} Mbases/s")

    # model-sharded capacity mode, data=1 x model=8 and data=2 x model=4
    for data, model in ((1, n_dev), (2, n_dev // 2)):
        mesh2 = make_2d_mesh(data, model)

        def run_sh():
            return sharded_fused_pml(mesh2, fi, alphas)

        ml_sh = np.asarray(run_sh())
        assert np.array_equal(ml_sh, ml_ref), "sharded mismatch"
        rate_sh = timeit(run_sh)
        print(f"sharded data={data} model={model}: "
              f"{rate_sh/1e6:.1f} Mbases/s "
              f"({rate_sh/rate_rep:.2f}x of replicated)")


if __name__ == "__main__":
    main()
