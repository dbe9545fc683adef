"""High-level API facade."""

import numpy as np

import movi_tpu
from movi_tpu.classify import EmpNullDatabase


def test_api_end_to_end(tmp_path):
    rng = np.random.default_rng(81)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seq = rng.choice(bases, size=3000).tobytes()
    ref = str(tmp_path / "ref.fa")
    with open(ref, "w") as f:
        f.write(f">doc1\n{seq.decode()}\n")

    index = movi_tpu.build_index(ref)
    index.save(str(tmp_path / "idx"))
    index2 = movi_tpu.Index.load(str(tmp_path / "idx"))

    reads = [("r0", seq[100:200]), ("r1", b"ACGT" * 10)]
    pml = dict(index2.query_pml(reads))
    assert len(pml["r0"]) == 100
    # exact substring: perfect backward run of matches
    assert max(pml["r0"]) >= 50

    cnt = dict(index2.query_count(reads))
    assert cnt["r0"] == (0, 1)  # exact substring, one fw occurrence
    zml = dict(index2.query_zml(reads))
    assert len(zml["r0"]) == 100

    mems = dict(index2.query_mems([("r0", seq[100:200])]))
    assert mems["r0"][0][:2] == (0, 100)

    kmers = dict(index2.query_kmers([("r0", seq[100:160])], k=21))
    assert sum(c for _, c in kmers["r0"]) == 40

    db = EmpNullDatabase()
    db.compute([1] * 10)
    found = dict(index2.classify(reads, nulldb=db))
    assert found["r0"] is True


def test_api_device_routing_matches_scalar(tmp_path):
    """query_mems / query_kmers(counts) / multi_classify route through
    the device engines and agree with the scalar fallbacks."""
    rng = np.random.default_rng(82)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    docs = [rng.choice(bases, size=1500) for _ in range(2)]
    ref = str(tmp_path / "ref.fa")
    with open(ref, "w") as f:
        for i, d in enumerate(docs):
            f.write(f">doc{i}\n{d.tobytes().decode()}\n")

    index = movi_tpu.build_index(ref)
    reads = []
    for i in range(10):
        d = int(rng.integers(0, 2))
        L = int(rng.integers(40, 100))
        s = int(rng.integers(0, len(docs[d]) - L))
        reads.append((f"r{i}", docs[d][s : s + L].tobytes()))

    for L in (0, 5):
        dev = dict(index.query_mems(reads, min_mem_length=L))
        cpu = dict(index.query_mems(reads, min_mem_length=L, jax=False))
        assert dev == cpu, L

    dev = dict(index.query_kmers(reads, k=15, counts=True))
    cpu = dict(index.query_kmers(reads, k=15, counts=True, jax=False))
    assert dev == cpu

    from movi_tpu.build.prepare_ref import prepare_ref
    from movi_tpu.build.suffix import build_bwt_runs
    from movi_tpu.color import DocumentInfo, build_color_table

    pref = prepare_ref(ref)
    runs = build_bwt_runs(pref.text)
    di = DocumentInfo.create(pref.doc_offsets)
    ct = build_color_table(index.ix, runs.sa, di)
    dev = dict(index.multi_classify(reads, ct))
    cpu = dict(index.multi_classify(reads, ct, jax=False))
    assert dev == cpu


def test_api_save_load_engine_caches(tmp_path):
    """Index.save persists the fused record cache; Index.load hydrates
    the engines from it (no O(r*sigma) rebuild) and results match."""
    import os

    rng = np.random.default_rng(83)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seq = rng.choice(bases, size=2000).tobytes()
    ref = str(tmp_path / "ref.fa")
    with open(ref, "w") as f:
        f.write(f">d\n{seq.decode()}\n")

    index = movi_tpu.build_index(ref)
    reads = [("r0", seq[50:120])]
    # materialize paired engines so their caches are saved too
    want_pml = index.query_pml(reads, paired=True)
    want_cnt = index.query_count(reads, paired=True)
    idx_dir = str(tmp_path / "idx")
    index.save(idx_dir)
    for fn in ("fused_records.npz", "paired_records.npz",
               "paired_search_records.npz"):
        assert os.path.exists(os.path.join(idx_dir, fn)), fn

    loaded = movi_tpu.Index.load(idx_dir)
    # hydrated from cache, not rebuilt lazily
    assert loaded._fused_pml is not None
    assert loaded._paired_pml is not None
    assert loaded._paired_search is not None
    assert loaded.query_pml(reads, paired=True) == want_pml
    assert loaded.query_count(reads, paired=True) == want_cnt
    assert loaded.query_pml(reads, paired=False) == want_pml


def test_engine_capacity_selection(monkeypatch):
    """engine/select.py: paired layouts are chosen exactly when their
    table fits the budgeted fraction of device memory and the run-id
    width."""
    from movi_tpu.engine import select
    from movi_tpu.engine.fused2 import MAX_RUNS as PML_MAX
    from movi_tpu.engine.fused_search2 import MAX_RUNS as S2_MAX

    monkeypatch.setenv("MOVI_TPU_HBM_BYTES", str(16 << 30))
    assert select.device_memory_budget() == 16 << 30
    # 5M runs * 400 B = 2 GB <= 8 GB budget fraction -> paired
    assert select.use_paired_pml(5_000_000, 4)
    # 3e7 runs * 400 B = 12 GB > 8 GB -> one-step
    assert not select.use_paired_pml(30_000_000, 4)
    assert select.use_paired_pml(30_000_000, 4, force=True)
    assert not select.use_paired_pml(5_000_000, 4, force=False)
    # run-id width caps
    assert not select.use_paired_pml(PML_MAX, 4)
    assert not select.use_paired_search(S2_MAX, 4)
    # 5M runs * 768 B = 3.8 GB <= 8 GB -> paired search
    assert select.use_paired_search(5_000_000, 4)
    assert not select.use_paired_search(12_000_000, 4)
    # small indexes take the paired layouts too: there is no separate
    # cache-residency rule (docs/PERF.md), only capacity and forcing
    assert select.use_paired_pml(122_000, 4)
    assert not select.use_paired_pml(122_000, 4, force=False)
    assert select.use_paired_search(39_000, 4)
    assert select.use_paired_color(80_000, 4, 100)
    assert not select.use_paired_color(80_000, 4, 0xFFFF)
    monkeypatch.setenv("MOVI_TPU_HBM_BYTES", str(1 << 30))
    assert not select.use_paired_pml(5_000_000, 4)


def test_api_mems_large_n_fallback(tmp_path, monkeypatch):
    """Past MEM2_MAX_N the API must route MEMs through the v1 engines
    (optional pos2rba) with identical results."""
    import movi_tpu.engine.fused_mem2 as fm2

    rng = np.random.default_rng(91)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    fw = rng.choice(bases, size=1200)
    comp = np.zeros(256, np.uint8)
    for a, b2 in zip(b"ACGT", b"TGCA"):
        comp[a] = b2
    ref = str(tmp_path / "r.fa")
    with open(ref, "w") as f:
        f.write(f">d\n{fw.tobytes().decode()}\n")
    index = movi_tpu.build_index(ref)
    reads = []
    for i in range(6):
        L = int(rng.integers(30, 80))
        s = int(rng.integers(0, len(fw) - L))
        reads.append((f"r{i}", fw[s : s + L].tobytes()))
    want0 = index.query_mems(reads, min_mem_length=0, jax=False)
    want12 = index.query_mems(reads, min_mem_length=12, jax=False)
    monkeypatch.setattr(fm2, "MEM2_MAX_N", 10)  # force the v1 fallback
    index2 = movi_tpu.Index(index.ix)
    assert index2.query_mems(reads, min_mem_length=0) == want0
    assert index2.query_mems(reads, min_mem_length=12) == want12
