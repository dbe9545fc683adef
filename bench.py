#!/usr/bin/env python
"""Headline benchmark: query throughput (bases/sec) on one GPU.

Reports the fused engines on two indexes:

  - the HEADLINE number: a synthetic ~5 M-run index (~200 MB of one-step
    records, ~2 GB paired) where every PML step is one random record
    gather from device memory;
  - `small_index_*`: the ~122 k-run index that `build_small` makes, whose
    one-step table fits the card's L2 cache, timed with the one-step and
    the paired engines for PML and count.

vs_baseline is MEASURED: the native single-core scalar PML loop
(native/movi_native.cpp, the reference's no-prefetch query path
move_structure_query.cpp:234-361 compiled -O3) runs on the SAME large
index and read set on this machine's CPU.  Without the native library
the baseline keys read "not measured".

Every result names the device it ran on; the run fails without a GPU,
and a section that fails fails the run.

Measurement notes:
  - The timed region runs REPS whole batches inside one jitted call and
    returns a checksum (uint32, wrapping); fetching the checksum is what
    waits for the device.
  - Inputs are perturbed per repetition to defeat loop-invariant
    hoisting, and the checksum depends on every rep to defeat CSE.
  - Index builds are cached under .bench_cache/ so re-runs skip the
    host-side synthetic build.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

LANES = int(os.environ.get("BENCH_LANES", 32768))
READ_LEN = int(os.environ.get("BENCH_READ_LEN", 150))
REPS = int(os.environ.get("BENCH_REPS", 20))
REPS_HBM = int(os.environ.get("BENCH_REPS_HBM", 8))
HBM_TEXT = int(os.environ.get("BENCH_HBM_TEXT", 6_000_000))
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_cache")


def make_reads(text, lanes, read_len, seed):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(text) - read_len, size=lanes)
    reads = np.stack([text[s: s + read_len] for s in starts])
    err = rng.random(reads.shape) < 0.01
    return np.where(err, rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                    size=reads.shape), reads)


def pml_rate(fi, reads, reps):
    """Timed fused-PML throughput (bases/sec) for one index."""
    import jax
    import jax.numpy as jnp

    from movi_tpu.engine.fused import fused_pml_step

    alphas = jnp.asarray(
        fi.alphamap_query[reads[:, ::-1]].T.astype(np.int32))
    slots = fi.sigma + 1
    lanes, read_len = reads.shape

    @jax.jit
    def run_reps(records, alphas):
        def onebatch(k, acc):
            idx0 = jnp.full((lanes,), fi.start_idx, jnp.int32)
            off0 = jnp.full((lanes,), fi.start_offset, jnp.int32)
            ml0 = jnp.zeros((lanes,), jnp.int32)

            def step(state, a):
                return fused_pml_step(records, slots, fi.p_dollar, state, a)

            # perturb the first char slot by k to defeat loop-invariant
            # hoisting across reps (k mod slots stays a legal slot)
            a0 = jnp.where(jnp.arange(lanes) == 0, (alphas[0] + k) % slots,
                           alphas[0])
            (_, _, _), ml = jax.lax.scan(
                step, (idx0, off0, ml0),
                jnp.concatenate([a0[None], alphas[1:]], axis=0))
            return acc + ml.astype(jnp.uint32).sum()

        return jax.lax.fori_loop(0, reps, onebatch, jnp.uint32(0))

    _ = np.asarray(run_reps(fi.records, alphas))  # compile + warm
    t0 = time.time()
    _ = int(np.asarray(run_reps(fi.records, alphas)))
    dt = (time.time() - t0) / reps
    return lanes * read_len / dt


def paired_pml_rate(f2, reads, reps):
    """Timed paired-record (fused2) throughput: one 16 B gather per two
    bases (engine/fused2.py)."""
    import jax
    import jax.numpy as jnp

    from movi_tpu.engine.fused2 import fused2_step, pack_pairs

    slots = f2.sigma + 1
    lanes, read_len = reads.shape
    a12, _ = pack_pairs(f2.alphamap_query[reads[:, ::-1]], f2.sigma)
    a12_t = jnp.asarray(a12)

    @jax.jit
    def run_reps(records, a12_t):
        a12_32 = a12_t.astype(jnp.int32)

        def onebatch(k, acc):
            st = (jnp.full((lanes,), f2.start_idx, jnp.int32),
                  jnp.full((lanes,), f2.start_offset, jnp.int32),
                  jnp.zeros((lanes,), jnp.int32))

            def step(s, a):
                return fused2_step(records, slots, f2.p_dollar, s, a)

            a0 = jnp.where(jnp.arange(lanes) == 0,
                           (a12_32[0] + k) % (slots * slots), a12_32[0])
            st, (ml1, ml2) = jax.lax.scan(
                step, st, jnp.concatenate([a0[None], a12_32[1:]]))
            return (acc + ml1.astype(jnp.uint32).sum()
                    + ml2.astype(jnp.uint32).sum())

        return jax.lax.fori_loop(0, reps, onebatch, jnp.uint32(0))

    _ = np.asarray(run_reps(f2.records, a12_t))  # compile + warm + transfer
    t0 = time.time()
    _ = int(np.asarray(run_reps(f2.records, a12_t)))
    dt = (time.time() - t0) / reps
    return lanes * read_len / dt


def paired_search_rate(s2, reads, reps, kind):
    """Timed paired-search throughput (bases/sec): count or zml at one
    composed 24 B record gather per base (engine/fused_search2.py)."""
    import jax
    import jax.numpy as jnp

    from movi_tpu.engine.fused_search2 import (_count2_init,
                                               _count_pair_body,
                                               _zml_pair_body,
                                               pack_search_pairs)

    lanes, read_len = reads.shape
    alphas = s2.alphamap_query[reads[:, ::-1]]
    a0 = jnp.asarray(alphas[:, 0].astype(np.int32))
    pairs, _ = pack_search_pairs(alphas[:, 1:], s2.sigma)
    pairs_t = jnp.asarray(pairs)

    if kind == "count":
        @jax.jit
        def run_reps(s2x, a0, pairs_t):
            def onebatch(k, acc):
                state = _count2_init(s2x, (a0 + k) % s2x.sigma)
                state, _ = jax.lax.scan(_count_pair_body(s2x), state,
                                        pairs_t.astype(jnp.int32))
                return (acc + state["matched"].astype(jnp.uint32).sum()
                        + state["rs"].astype(jnp.uint32).sum())
            return jax.lax.fori_loop(0, reps, onebatch, jnp.uint32(0))
    else:
        @jax.jit
        def run_reps(s2x, a0, pairs_t):
            body = _zml_pair_body(s2x)

            def onebatch(k, acc):
                zero = jnp.zeros((lanes,), jnp.int32)
                state = dict(rs=zero, os=zero, re=zero, oe=zero,
                             have=jnp.zeros((lanes,), bool), ml=zero)
                # perturb the first packed pair per rep (stays in the
                # legal 6-bit range) to defeat loop-invariant hoisting
                p0 = (pairs_t[0].astype(jnp.int32) + k) % 64
                xs = jnp.concatenate(
                    [p0[None], pairs_t[1:].astype(jnp.int32)])
                state, (ml1, ml2) = jax.lax.scan(body, state, xs)
                return (acc + ml1.astype(jnp.uint32).sum()
                        + ml2.astype(jnp.uint32).sum()
                        + state["ml"].astype(jnp.uint32).sum())
            return jax.lax.fori_loop(0, reps, onebatch, jnp.uint32(0))

    _ = np.asarray(run_reps(s2, a0, pairs_t))  # compile + warm
    t0 = time.time()
    _ = int(np.asarray(run_reps(s2, a0, pairs_t)))
    dt = (time.time() - t0) / reps
    return lanes * read_len / dt


def paired_color_rate(f2c, reads, reps):
    """Timed paired Movi Color throughput: PML + per-base color ids at
    one 32 B gather per TWO bases (engine/fused2.py color records)."""
    import jax
    import jax.numpy as jnp

    from movi_tpu.engine.fused2 import fused2_color_step, pack_pairs

    slots = f2c.sigma + 1
    lanes, read_len = reads.shape
    a12, _ = pack_pairs(f2c.alphamap_query[reads[:, ::-1]], f2c.sigma)
    a12_t = jnp.asarray(a12)

    @jax.jit
    def run_reps(f2x, a12_t):
        a12_32 = a12_t.astype(jnp.int32)

        def onebatch(k, acc):
            st = (jnp.full((lanes,), f2x.start_idx, jnp.int32),
                  jnp.full((lanes,), f2x.start_offset, jnp.int32),
                  jnp.zeros((lanes,), jnp.int32))

            def step(s, a):
                return fused2_color_step(f2x.records, slots,
                                         f2x.p_dollar, s, a)

            a0 = jnp.where(jnp.arange(lanes) == 0,
                           (a12_32[0] + k) % (slots * slots), a12_32[0])
            st, (ml1, ml2, c1, c2) = jax.lax.scan(
                step, st, jnp.concatenate([a0[None], a12_32[1:]]))
            return (acc + ml1.astype(jnp.uint32).sum()
                    + ml2.astype(jnp.uint32).sum()
                    + c1.astype(jnp.uint32).sum()
                    + c2.astype(jnp.uint32).sum())

        return jax.lax.fori_loop(0, reps, onebatch, jnp.uint32(0))

    _ = np.asarray(run_reps(f2c, a12_t))
    t0 = time.time()
    _ = int(np.asarray(run_reps(f2c, a12_t)))
    dt = (time.time() - t0) / reps
    return lanes * read_len / dt


def load_large_move_index():
    """The full MoveIndex of the HBM-scale synthetic text (cached): the
    paired search compose needs the next-run tables, which the fused
    cache does not carry."""
    from movi_tpu.index.structure import MoveIndex, build_move_index

    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, f"hbm_{HBM_TEXT}.index.npz")
    if os.path.exists(path):
        try:
            return MoveIndex.load(path)
        except Exception:
            pass
    from movi_tpu.build.suffix import build_bwt_runs

    rng = np.random.default_rng(0)
    text = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8),
                      size=HBM_TEXT)
    ix = build_move_index(build_bwt_runs(text), "regular-thresholds",
                          bound_ff=1)
    ix.save(path)
    return ix


def build_small():
    """The small index: 200 kb of seeded random text (r ~ 122 k), whose
    one-step record table (~5 MB) fits the card's L2 cache.  Returns
    (MoveIndex, text)."""
    from movi_tpu.build.suffix import build_bwt_runs
    from movi_tpu.index.structure import build_move_index

    rng = np.random.default_rng(0)
    text = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=200000)
    runs = build_bwt_runs(text)
    return build_move_index(runs, "regular-thresholds", bound_ff=1), text


def build_large():
    """Synthetic ~5 M-run index (cached).  Returns (fused_index, reads,
    baseline_arrays_or_None)."""
    from movi_tpu.engine.fused import (build_fused_index, load_fused_index,
                                       save_fused_index)

    os.makedirs(CACHE_DIR, exist_ok=True)
    tag = f"hbm_{HBM_TEXT}"
    fi_path = os.path.join(CACHE_DIR, f"{tag}.fused.npz")
    base_path = os.path.join(CACHE_DIR, f"{tag}.baseline.npz")

    rng = np.random.default_rng(0)
    text = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=HBM_TEXT)
    reads = make_reads(text, LANES, READ_LEN, seed=42)

    if os.path.exists(fi_path) and os.path.exists(base_path):
        try:
            fi = load_fused_index(fi_path)
            base = dict(np.load(base_path))
            return fi, reads, base
        except Exception:
            pass

    from movi_tpu.build.suffix import build_bwt_runs
    from movi_tpu.engine.device_index import build_thr_full
    from movi_tpu.index.structure import build_move_index

    runs = build_bwt_runs(text)
    ix = build_move_index(runs, "regular-thresholds", bound_ff=1)
    fi = build_fused_index(ix)
    base = {
        "n": ix.n_arr.astype(np.int32),
        "off": ix.offset_arr.astype(np.int32),
        "id": ix.id_arr.astype(np.int64),
        "c": ix.c_arr.astype(np.uint8),
        "thr": build_thr_full(ix).astype(np.uint16),
        "sigma": np.int64(ix.sigma),
    }
    save_fused_index(fi, fi_path)
    np.savez(base_path, **base)
    return fi, reads, base


def ensure_native_built():
    """Build native/libmovi_native.so when absent (it is gitignored) so
    the CPU baselines can be measured; without it they read "not
    measured"."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    native = os.path.join(here, "native")
    if not os.path.exists(os.path.join(native, "libmovi_native.so")):
        subprocess.run(["make", "-C", native], capture_output=True)


def measure_native_baseline(fi, base, reads):
    """Single-core scalar PML rate on the same index + reads (bases/s)."""
    from movi_tpu.cpu_ref.native_pml import _load

    ensure_native_built()
    lib = _load()
    if not lib:
        return None
    import ctypes
    n_reads = min(len(reads), 20000)
    alphas = np.ascontiguousarray(
        fi.alphamap_query[reads[:n_reads, ::-1]].astype(np.uint8))
    args = [np.ascontiguousarray(base["n"]),
            np.ascontiguousarray(base["off"]),
            np.ascontiguousarray(base["id"]),
            np.ascontiguousarray(base["c"]),
            np.ascontiguousarray(base["thr"])]
    ptrs = [a.ctypes.data_as(ctypes.POINTER(t)) for a, t in zip(
        args, [ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
               ctypes.c_uint8, ctypes.c_uint16])]
    r = int(len(base["n"]))
    sigma = int(base["sigma"])
    t0 = time.time()
    lib.movi_scalar_pml(
        *ptrs, ctypes.c_int64(r), ctypes.c_int32(sigma),
        alphas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n_reads), ctypes.c_int64(READ_LEN))
    dt = time.time() - t0
    return n_reads * READ_LEN / dt


HBM_RC_HALF = int(os.environ.get("BENCH_RC_HALF", HBM_TEXT // 2))
KMER_K = int(os.environ.get("BENCH_KMER_K", 31))
MEM_L = int(os.environ.get("BENCH_MEM_L", 20))
MEM_LANES = int(os.environ.get("BENCH_MEM_LANES", 16384))


def load_large_rc_index():
    """rc-complete HBM-scale MoveIndex (cached): the bidirectional
    engines (MEM, exact k-mer counts) require the reverse complement in
    the index (prepare_ref default; mem_finder.cpp:6)."""
    from movi_tpu.index.structure import MoveIndex, build_move_index

    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, f"hbm_rc_{HBM_RC_HALF}.index.npz")
    rng = np.random.default_rng(1)
    half = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8),
                      size=HBM_RC_HALF)
    if os.path.exists(path):
        try:
            return MoveIndex.load(path), half
        except Exception:
            pass
    from movi_tpu.build.suffix import build_bwt_runs
    from movi_tpu.synth import revcomp

    text = np.concatenate([half, revcomp(half)])
    ix = build_move_index(build_bwt_runs(text), "regular-thresholds",
                          bound_ff=1)
    ix.save(path)
    return ix, half


def make_mixed_reads(text, lanes, read_len, seed):
    """Half drawn-from-reference, half random: the contamination-
    screening workload for the k-mer engines (half the windows are
    found, half are not)."""
    rng = np.random.default_rng(seed)
    found = make_reads(text, lanes // 2, read_len, seed=seed + 1)
    rand = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                      size=(lanes - lanes // 2, read_len))
    reads = np.concatenate([found, rand])
    return reads[rng.permutation(lanes)]


def _to_batch(reads_arr: np.ndarray):
    from movi_tpu.io.fastx import ReadBatch

    lanes, W = reads_arr.shape
    return ReadBatch(names=[str(i) for i in range(lanes)],
                     seqs=np.ascontiguousarray(reads_arr),
                     lengths=np.full(lanes, W, np.int32))


def _time_query_batch(engine, batch, reps=2):
    """Wall-time of the best of `reps` query_batch calls after a
    compile+warm call (host parse, transfers and unpacking included)."""
    engine.query_batch(batch)
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        engine.query_batch(batch)
        best = min(best, time.time() - t0)
    return best


def _best_of(fn, reps=2):
    """Fastest of `reps` runs (the CPU baselines drift ~±30% with host
    load; min is the stable estimator, same policy as the device side)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        fn()
        best = min(best, time.time() - t0)
    return best


def measure_native_search_baselines(ix, reads, out):
    """Measured single-core count/ZML rates on the same (non-rc) index
    and reads as the device count/ZML sections."""
    from movi_tpu.cpu_ref.native_search import (
        NativeSearchCtx, native_count_checksum, native_search_available,
        native_zml_checksum, reads_to_slots)

    if not native_search_available():
        return None

    n1 = min(len(reads), 20000)
    slots = reads_to_slots(ix, reads[:n1])
    ctx = NativeSearchCtx(ix)
    bases = slots.size
    out["baseline_measured_count_bases_per_sec"] = (
        bases / _best_of(lambda: native_count_checksum(ctx, slots)))
    out["baseline_measured_zml_bases_per_sec"] = (
        bases / _best_of(lambda: native_zml_checksum(ctx, slots)))
    return ctx


def measure_native_rc_baselines(ix_rc, reads_mixed, reads_mem, out):
    """Measured single-core k-mer membership/count and MEM rates on the
    rc-complete index (the same workloads as the device engines)."""
    from movi_tpu.cpu_ref.native_search import (
        NativeSearchCtx, native_kmer_count, native_kmer_membership,
        native_mem_bml, native_search_available, reads_to_slots)

    if not native_search_available():
        return
    ctx = NativeSearchCtx(ix_rc, with_bidir=True)
    k = KMER_K
    nm = min(len(reads_mixed), 20000)
    slots = reads_to_slots(ix_rc, reads_mixed[:nm])
    windows = nm * (reads_mixed.shape[1] - k + 1)
    out["baseline_measured_kmer_membership_per_sec"] = (
        windows / _best_of(lambda: native_kmer_membership(ctx, slots, k)))
    nc = min(len(reads_mixed), 4000)
    out["baseline_measured_kmer_counts_per_sec"] = (
        nc * (reads_mixed.shape[1] - k + 1)
        / _best_of(lambda: native_kmer_count(ctx, slots[:nc], k)))
    nb = min(len(reads_mem), 4000)
    slots_m = reads_to_slots(ix_rc, reads_mem[:nb])
    out["baseline_measured_mem_bases_per_sec"] = (
        slots_m.size / _best_of(lambda: native_mem_bml(ctx, slots_m,
                                                       MEM_L)))


def _ratio(out, num_key, den_key, ratio_key):
    """out[ratio_key] = num / den where both were measured."""
    den = out.get(den_key)
    if num_key in out and isinstance(den, float) and den > 0:
        out[ratio_key] = out[num_key] / den


def rc_sections(out):
    """Device MEM / k-mer membership / k-mer count measurements on the
    rc-complete HBM index, plus their measured CPU denominators."""
    import gc

    from movi_tpu.engine.fused_kmer import FusedKmerEngine
    from movi_tpu.engine.fused_kmer2 import FusedKmer2CountEngine
    from movi_tpu.engine.fused_mem2 import (FusedMem2Engine,
                                            build_fused_mem2_index)
    from movi_tpu.engine.fused_search import build_fused_search_index
    from movi_tpu.engine.fused_search2 import build_fused_search2_index

    ix_rc, half = load_large_rc_index()
    out["rc_index_runs"] = int(ix_rc.r)
    reads_mixed = make_mixed_reads(half, LANES, READ_LEN, seed=77)
    reads_mem = make_reads(half, MEM_LANES, READ_LEN, seed=78)
    measure_native_rc_baselines(ix_rc, reads_mixed, reads_mem, out)

    k = KMER_K
    m2 = build_fused_mem2_index(ix_rc, ftab_k=min(10, MEM_L))
    batch_mem = _to_batch(reads_mem)
    dt = _time_query_batch(FusedMem2Engine(m2, MEM_L), batch_mem)
    out["hbm_mem_bases_per_sec"] = reads_mem.size / dt
    _ratio(out, "hbm_mem_bases_per_sec",
           "baseline_measured_mem_bases_per_sec", "vs_baseline_mem")

    s2 = build_fused_search2_index(ix_rc)
    batch_kc = _to_batch(reads_mixed[:MEM_LANES])
    windows = batch_kc.lanes * (READ_LEN - k + 1)
    dt = _time_query_batch(FusedKmer2CountEngine(m2, s2, k), batch_kc)
    out["hbm_kmer_counts_per_sec"] = windows / dt
    _ratio(out, "hbm_kmer_counts_per_sec",
           "baseline_measured_kmer_counts_per_sec",
           "vs_baseline_kmer_counts")
    del s2, m2
    gc.collect()

    si_rc = build_fused_search_index(ix_rc, ftab_k=min(10, k - k // 3))
    batch_kmer = _to_batch(reads_mixed[:MEM_LANES])
    windows = batch_kmer.lanes * (READ_LEN - k + 1)
    dt = _time_query_batch(FusedKmerEngine(si_rc, k), batch_kmer)
    out["hbm_kmer_membership_per_sec"] = windows / dt
    _ratio(out, "hbm_kmer_membership_per_sec",
           "baseline_measured_kmer_membership_per_sec",
           "vs_baseline_kmer_membership")
    del si_rc
    gc.collect()


def small_index_sections(out):
    """One-step against paired engines on the small index, PML and
    count, through each engine's query_batch: the comparison that
    decides whether small indexes need their own engine rule."""
    from movi_tpu.engine.fused import FusedPMLEngine, build_fused_index
    from movi_tpu.engine.fused2 import Fused2PMLEngine, build_fused2_index
    from movi_tpu.engine.fused_search import (FusedCountEngine,
                                              build_fused_search_index)
    from movi_tpu.engine.fused_search2 import (Fused2CountEngine,
                                               build_fused_search2_index)

    ix, text = build_small()
    reads = make_reads(text, LANES, READ_LEN, seed=42)
    out["small_index_runs"] = int(ix.r)
    fi = build_fused_index(ix)
    out["small_index_bases_per_sec"] = pml_rate(fi, reads, REPS)
    out["small_index_paired_bases_per_sec"] = paired_pml_rate(
        build_fused2_index(fi), reads, REPS)
    batch = _to_batch(reads)
    engines = {
        "pml_one_step": FusedPMLEngine(fi),
        "pml_paired": Fused2PMLEngine(build_fused2_index(fi)),
        "count_one_step": FusedCountEngine(build_fused_search_index(ix)),
        "count_paired": Fused2CountEngine(build_fused_search2_index(ix)),
    }
    for name, eng in engines.items():
        out[f"small_index_{name}_query_batch_bases_per_sec"] = (
            reads.size / _time_query_batch(eng, batch, reps=5))


def main():
    import gc

    from movi_tpu import runtime

    runtime.require_gpu()
    runtime.enable_compile_cache()
    ensure_native_built()
    facts = runtime.device_facts()
    out = {"platform": facts["platform"], "device_kind": facts["kind"],
           "device_count": facts["count"],
           "card": runtime.card_name_and_power_limit().splitlines()[0]}

    fi_hbm, reads_hbm, base = build_large()
    out["hbm_index_runs"] = int(fi_hbm.r)
    out["record_bytes_per_row"] = 8 * (fi_hbm.sigma + 1)
    sigma = fi_hbm.sigma

    baseline = measure_native_baseline(fi_hbm, base, reads_hbm)
    out["baseline_measured_bases_per_sec"] = (
        baseline if baseline is not None else "not measured")

    hbm_rate = pml_rate(fi_hbm, reads_hbm, REPS_HBM)
    out["hbm_single_gather_bases_per_sec"] = hbm_rate

    if os.environ.get("BENCH_PAIRED", "1") != "0":
        # paired 16 B records: one gather per TWO bases (the speed
        # layout; 400 B/run).  Takes the headline when faster.
        from movi_tpu.engine.fused2 import (Fused2Index, build_fused2_index,
                                            compose_records)

        f2 = build_fused2_index(fi_hbm)
        paired_rate = paired_pml_rate(f2, reads_hbm, REPS_HBM)
        out["hbm_paired_gather_bases_per_sec"] = paired_rate
        out["paired_record_bytes_per_row"] = 16 * (sigma + 1) ** 2
        hbm_rate = max(hbm_rate, paired_rate)
        f2_meta = (f2.start_idx, f2.start_offset, f2.p_dollar,
                   f2.alphamap_query)
        # free the 400 B/run paired table before composing the 800 B/run
        # color table
        del f2
        gc.collect()

        # paired Movi Color (32 B records, one gather per two bases).
        # The color ids are synthetic (random < 2^16): the gather cost
        # -- the thing measured -- is independent of the coloring.
        if os.environ.get("BENCH_COLOR", "1") != "0":
            import jax.numpy as jnp

            rngc = np.random.default_rng(9)
            cids = jnp.asarray(rngc.integers(
                0, 60000, size=fi_hbm.r).astype(np.int32))
            crecords, _ = compose_records(fi_hbm.records, r=fi_hbm.r,
                                          slots=sigma + 1,
                                          p_dollar=fi_hbm.p_dollar,
                                          cids=cids)
            f2c = Fused2Index(r=fi_hbm.r, sigma=sigma, records=crecords,
                              start_idx=f2_meta[0],
                              start_offset=f2_meta[1],
                              p_dollar=f2_meta[2],
                              alphamap_query=f2_meta[3])
            del crecords, cids
            color_rate = paired_color_rate(f2c, reads_hbm, REPS_HBM)
            out["hbm_color_paired_bases_per_sec"] = color_rate
            # conservative denominator: the PML loop (the CPU's color
            # query does strictly more work per base)
            _ratio(out, "hbm_color_paired_bases_per_sec",
                   "baseline_measured_bases_per_sec", "vs_baseline_color")
            del f2c
            gc.collect()

    if os.environ.get("BENCH_SEARCH", "1") != "0":
        # paired backward-search records: count and ZML at one composed
        # 24 B record gather per base (engine/fused_search2.py)
        from movi_tpu.engine.fused_search2 import build_fused_search2_index

        ix_hbm = load_large_move_index()
        measure_native_search_baselines(ix_hbm, reads_hbm, out)
        s2 = build_fused_search2_index(ix_hbm)
        del ix_hbm
        out["hbm_count_bases_per_sec"] = paired_search_rate(
            s2, reads_hbm, REPS_HBM, "count")
        out["hbm_zml_bases_per_sec"] = paired_search_rate(
            s2, reads_hbm, REPS_HBM, "zml")
        out["paired_search_bytes_per_run"] = 2 * 24 * sigma * sigma
        _ratio(out, "hbm_count_bases_per_sec",
               "baseline_measured_count_bases_per_sec", "vs_baseline_count")
        _ratio(out, "hbm_zml_bases_per_sec",
               "baseline_measured_zml_bases_per_sec", "vs_baseline_zml")
        del s2
        gc.collect()

    if os.environ.get("BENCH_RC", "1") != "0":
        # rc-complete index sections: device MEM, k-mer membership, and
        # exact k-mer counts with their measured CPU denominators
        rc_sections(out)

    if os.environ.get("BENCH_LONGREAD", "1") != "0":
        # long-read regime: 1,500 b reads in one fused PML scan.  The
        # text expression must match build_large's generator exactly so
        # the reads stay drawn from the indexed text.
        reads_long = make_reads(
            np.random.default_rng(0).choice(
                np.frombuffer(b"ACGT", np.uint8), size=HBM_TEXT),
            4096, 1500, seed=43)
        out["hbm_longread_pml_bases_per_sec"] = pml_rate(
            fi_hbm, reads_long, max(REPS_HBM // 2, 1))

    small_index_sections(out)

    print(json.dumps({
        "metric": "pml_bases_per_sec_per_gpu_hbm",
        "value": hbm_rate,
        "unit": "bases/sec",
        "vs_baseline": (hbm_rate / baseline if baseline is not None
                        else "not measured"),
        **out,
    }))


if __name__ == "__main__":
    main()
