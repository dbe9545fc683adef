"""Parity tests for the reference's standalone subcommands and query
flags added on top of the core build/query flows:

  build-SA / ftab / color / color-move-rows / rlbwt / prepare-ref
  (movi.cpp:640-740), --rpml, --logs, --mmap, --no-output, --report-all,
  --early-stop (movi_parser.cpp), plus the preprocessed --bwt-file build
  path (move_structure_build.cpp:143-202).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import REF_DATA, requires_ref_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-m", "movi_tpu.cli"] + args,
                          cwd=cwd, env=env, capture_output=True, text=True)


@pytest.fixture(scope="module")
def built_index(tmp_path_factory):
    idx = str(tmp_path_factory.mktemp("parity") / "idx")
    r = _run(["build", "--fasta", os.path.join(REF_DATA, "ref.fasta"),
              "--index", idx, "--skip-null", "--mmap"])
    assert r.returncode == 0, r.stderr
    return idx


@requires_ref_data
def test_lf_sweep_matches_sa(built_index):
    from movi_tpu.build.prepare_ref import prepare_ref
    from movi_tpu.build.suffix import build_bwt_runs
    from movi_tpu.index.structure import MoveIndex
    from movi_tpu.index.sweeps import lf_sweep

    ix = MoveIndex.load(os.path.join(built_index, "index.npz"))
    runs = build_bwt_runs(
        prepare_ref(os.path.join(REF_DATA, "ref.fasta")).text)
    sa, _ = lf_sweep(ix, sa_sample_rate=100)
    assert np.array_equal(sa, runs.sampled_sa(100))


@requires_ref_data
def test_build_sa_subcommand(built_index):
    r = _run(["build-SA", "--index", built_index, "--sample-rate", "50"])
    assert r.returncode == 0, r.stderr
    from movi_tpu.index.structure import MoveIndex

    ix = MoveIndex.load(os.path.join(built_index, "index.npz"))
    assert ix.sampled_SA is not None and ix.sa_sample_rate == 50


@requires_ref_data
def test_ftab_and_color_subcommands(built_index):
    r = _run(["ftab", "--index", built_index, "--ftab-k", "6",
              "--multi-ftab"])
    assert r.returncode == 0, r.stderr
    for k in (6, 4, 2):
        assert os.path.exists(os.path.join(built_index, f"ftab.{k}.npy"))

    r = _run(["color", "--index", built_index, "--full"])
    assert r.returncode == 0, r.stderr
    assert os.path.exists(os.path.join(built_index, "colors.npz"))
    assert os.path.exists(os.path.join(built_index, "doc_pats.npy"))

    # standalone color (LF-sweep doc_pats) == build-time color (SA-based)
    from movi_tpu.build.prepare_ref import prepare_ref
    from movi_tpu.build.suffix import build_bwt_runs
    from movi_tpu.color import (ColorTable, DocumentInfo, build_color_table)
    from movi_tpu.index.structure import MoveIndex

    ix = MoveIndex.load(os.path.join(built_index, "index.npz"))
    ref = prepare_ref(os.path.join(REF_DATA, "ref.fasta"))
    runs = build_bwt_runs(ref.text)
    want = build_color_table(ix, runs.sa, DocumentInfo.create(ref.doc_offsets))
    got = ColorTable.load(os.path.join(built_index, "colors.npz"))
    assert np.array_equal(got.doc_pats, want.doc_pats)
    assert np.array_equal(got.doc_set_inds, want.doc_set_inds)

    r = _run(["color-move-rows", "--index", built_index])
    assert r.returncode == 0, r.stderr
    assert os.path.exists(os.path.join(built_index, "index_colored.movi"))


@requires_ref_data
def test_bwt_file_build_path(tmp_path):
    """rlbwt preprocessing + build --bwt-file must reproduce the FASTA
    build bit-exactly (PML golden)."""
    from movi_tpu.build.prepare_ref import prepare_ref
    from movi_tpu.build.suffix import build_bwt_runs

    runs = build_bwt_runs(
        prepare_ref(os.path.join(REF_DATA, "ref.fasta")).text)
    bwt_path = str(tmp_path / "ref.bwt")
    runs.bwt.tofile(bwt_path)
    with open(str(tmp_path / "ref.thr_pos"), "wb") as f:
        for t in runs.thresholds:
            f.write(int(t).to_bytes(5, "little"))

    r = _run(["rlbwt", "--bwt-file", bwt_path])
    assert r.returncode == 0, r.stderr
    assert os.path.exists(bwt_path + ".heads")
    assert os.path.exists(bwt_path + ".len")

    idx = str(tmp_path / "idx")
    r = _run(["build", "--bwt-file", bwt_path, "--index", idx,
              "--skip-null"])
    assert r.returncode == 0, r.stderr
    r = _run(["query", "--index", idx,
              "--read", os.path.join(REF_DATA, "sample.fastq"),
              "--pml", "--stdout", "--no-jax"])
    assert r.returncode == 0, r.stderr
    got = sorted(r.stdout.splitlines(), key=str.encode)
    with open(os.path.join(REF_DATA, "sample.fastq.pmls.sorted")) as f:
        want = f.read().splitlines()
    assert got == want


@requires_ref_data
def test_query_flag_surface(built_index, tmp_path):
    reads = os.path.join(REF_DATA, "sample.fastq")
    # --no-output writes nothing
    r = _run(["query", "--index", built_index, "--read", reads, "--pml",
              "--no-jax", "--no-output"], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert not any(f.endswith(".bpf") for f in os.listdir(tmp_path))

    # --rpml (random repositioning) still yields plausible PMLs
    r = _run(["query", "--index", built_index, "--read", reads, "--pml",
              "--no-jax", "--rpml", "--stdout"])
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith(">")

    # --logs writes the .costs/.scans/.fastforwards trio
    r = _run(["query", "--index", built_index, "--read", reads, "--pml",
              "--logs", "--no-output", "--out-file", str(tmp_path / "x")])
    assert r.returncode == 0, r.stderr
    for ext in (".costs", ".scans", ".fastforwards"):
        assert os.path.exists(reads + ".regular-thresholds.pml" + ext)
        os.remove(reads + ".regular-thresholds.pml" + ext)

    # --mmap path produces identical PMLs
    a = _run(["query", "--index", built_index, "--read", reads, "--pml",
              "--no-jax", "--stdout"])
    b = _run(["query", "--index", built_index, "--read", reads, "--pml",
              "--no-jax", "--stdout", "--mmap"])
    assert a.stdout == b.stdout

    # compat flags are accepted
    r = _run(["query", "--index", built_index, "--read", reads, "--pml",
              "--no-jax", "--stdout", "-s", "16", "-t", "4",
              "--no-prefetch"])
    assert r.returncode == 0, r.stderr

    # --validate-flags parses and exits without running
    r = _run(["query", "--index", "/nonexistent", "--read", reads,
              "--pml", "--validate-flags"])
    assert r.returncode == 0 and "flags OK" in r.stdout


@requires_ref_data
def test_multiclass_report_all(built_index):
    reads = os.path.join(REF_DATA, "sample.fastq")
    r = _run(["query", "--index", built_index, "--read", reads, "--pml",
              "--multi-classify", "--report-all", "--early-stop",
              "--stdout"])
    assert r.returncode == 0, r.stderr
    # single-document reference: cells are either "0" (unclassified,
    # report-all writes a single 0) or the doc's taxon id
    for line in r.stdout.splitlines():
        name, _, cell = line.partition(",")
        assert cell in ("0", "1"), line


def test_report_all_cells_synthetic():
    """Cell formats of read_processor.cpp:489-561 on a controlled
    two-document reference."""
    from movi_tpu.build.suffix import build_bwt_runs
    from movi_tpu.color import (ColorEngine, DocumentInfo,
                                build_color_table)
    from movi_tpu.index.structure import build_move_index

    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    doc_a = rng.choice(bases, size=3000)
    doc_b = rng.choice(bases, size=3000)
    text = np.concatenate([doc_a, doc_b])
    runs = build_bwt_runs(text)
    ix = build_move_index(runs, "regular-thresholds")
    di = DocumentInfo.create([3000, 6000], taxon_ids=[11, 22])
    ct = build_color_table(ix, runs.sa, di)

    read = doc_a[100:250].tobytes()
    base = ColorEngine(ix, ct)
    _, cell = base.query_pml_multiclass(read)
    assert cell.split(",")[0] == "11"

    ra = ColorEngine(ix, ct, report_all=True)
    _, cell_all = ra.query_pml_multiclass(read)
    assert cell_all.split(",")[0] == "11"

    # min-score-frac mode: a threshold of 0 votes reports every doc seen,
    # prefixed with a comma (read_processor.cpp:527-541)
    msf = ColorEngine(ix, ct, report_all=True, min_score_frac=1e-9)
    _, cell_msf = msf.query_pml_multiclass(read)
    assert cell_msf.startswith(",")
    assert "11" in cell_msf.split(",")

    # report_colors records one entry per counted base
    rc = ColorEngine(ix, ct, report_colors=True)
    pmls, _ = rc.query_pml_multiclass(read)
    assert len(rc.last_colors) == len(pmls)


def test_read_bpf_headerless(tmp_path):
    from movi_tpu.io.outputs import read_bpf

    p = str(tmp_path / "legacy.bpf")
    import struct

    with open(p, "wb") as f:
        name = b"r1"
        f.write(struct.pack("<H", len(name)))
        f.write(name)
        vals = [3, 2, 1]
        f.write(struct.pack("<Q", len(vals)))
        f.write(struct.pack("<3I", *vals))
    got = read_bpf(p, entry_size_hint=32)
    assert got == [("r1", [3, 2, 1])]


def test_native_fastx_reader(tmp_path):
    """C++ batched reader == Python parser (iter_fastx, make_batches),
    incl. gz, multi-line FASTA, CRLF, and --reverse packing."""
    import gzip

    from movi_tpu.io.fastx import batches_from_file, iter_fastx, make_batches

    from movi_tpu import synth

    fq = str(tmp_path / "sample.fastq")
    reads = synth.sample_reads([synth.ACGT.repeat(50)], 40, 120, seed=5)
    synth.write_fastq(fq, [f"read{i} comment" for i in range(40)], reads)
    fa = str(tmp_path / "multi.fa")
    with open(fa, "w") as f:
        f.write(">r1 comment\r\nACGT\r\nACGTAC\r\n>r2\nTTTT\n\n>r3 x\nGG\n")
    gz = str(tmp_path / "s.fastq.gz")
    with open(fq, "rb") as f:
        data = f.read()
    with gzip.open(gz, "wb") as f:
        f.write(data)
    for p in (fq, fa, gz):
        assert list(iter_fastx(p, native=True)) == \
            list(iter_fastx(p, native=False)), p
        for rev in (False, True):
            want = list(make_batches(list(iter_fastx(p, native=False)),
                                     lanes=7, reverse=rev))
            got = list(batches_from_file(p, lanes=7, reverse=rev))
            assert len(want) == len(got)
            for a, b in zip(want, got):
                assert a.names == b.names
                assert np.array_equal(a.seqs, b.seqs), (p, rev)
                assert np.array_equal(a.lengths, b.lengths)


@requires_ref_data
def test_kmer_duplicate_read_names(built_index, tmp_path):
    """Reads with duplicate names must each report their OWN length;
    the kmer denominator is L - k + 1 per read (sequitur.cpp output),
    so a name collision that reused another read's length shows up here."""
    with open(os.path.join(REF_DATA, "sample.fasta")) as f:
        seq = f.read().splitlines()[1]
    reads = str(tmp_path / "dups.fa")
    with open(reads, "w") as f:
        f.write(f">r1\n{seq}\n>r1\n{seq[:40]}\n")
    r = _run(["query", "--index", built_index, "--read", reads,
              "--kmer", "--k", "15", "--stdout"])
    assert r.returncode == 0, r.stderr
    out = [ln for ln in r.stdout.splitlines() if ln]
    assert len(out) == 2
    denoms = [ln.split("\t")[1].split("/")[1] for ln in out]
    assert denoms[0] == str(len(seq) - 15 + 1)
    assert denoms[1] == str(40 - 15 + 1)
    # kmer-count path shares the same per-read length plumbing
    r = _run(["query", "--index", built_index, "--read", reads,
              "--kmer-count", "--k", "15", "--stdout"])
    assert r.returncode == 0, r.stderr
    out = [ln for ln in r.stdout.splitlines() if ln]
    denoms = [ln.split("\t")[1].split("/")[1] for ln in out]
    assert denoms[0] == str(len(seq) - 15 + 1)
    assert denoms[1] == str(40 - 15 + 1)


@requires_ref_data
def test_bwt_file_build_color(tmp_path):
    """build --bwt-file --color must work (no SA on that path: doc_pats
    come from the LF sweep, move_structure_color.cpp:4-24) and match the
    SA-derived color table from the FASTA path bit-exactly."""
    from movi_tpu.build.prepare_ref import prepare_ref
    from movi_tpu.build.suffix import build_bwt_runs
    from movi_tpu.color import ColorTable

    ref = prepare_ref(os.path.join(REF_DATA, "ref.fasta"))
    runs = build_bwt_runs(ref.text)
    bwt_path = str(tmp_path / "ref.bwt")
    runs.bwt.tofile(bwt_path)
    with open(str(tmp_path / "ref.thr_pos"), "wb") as f:
        for t in runs.thresholds:
            f.write(int(t).to_bytes(5, "little"))

    idx = str(tmp_path / "idx")
    # without doc_offsets the build must fail with a clear message
    r = _run(["build", "--bwt-file", bwt_path, "--index", idx,
              "--skip-null", "--color"])
    assert r.returncode != 0
    assert "doc_offsets" in (r.stderr + r.stdout)

    os.makedirs(idx, exist_ok=True)
    with open(os.path.join(idx, "ref.fa.doc_offsets"), "w") as f:
        for off in ref.doc_offsets:
            f.write(f"{off}\n")
    r = _run(["build", "--bwt-file", bwt_path, "--index", idx,
              "--skip-null", "--color"])
    assert r.returncode == 0, r.stderr

    idx_fa = str(tmp_path / "idx_fa")
    r = _run(["build", "--fasta", os.path.join(REF_DATA, "ref.fasta"),
              "--index", idx_fa, "--skip-null", "--color"])
    assert r.returncode == 0, r.stderr
    got = ColorTable.load(os.path.join(idx, "colors.npz"))
    want = ColorTable.load(os.path.join(idx_fa, "colors.npz"))
    assert np.array_equal(got.doc_pats, want.doc_pats)
    assert np.array_equal(got.doc_set_inds, want.doc_set_inds)
