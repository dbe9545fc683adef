"""End-to-end CLI tests (subprocess), matching the reference's golden
test style: build then query then diff."""

import os
import subprocess
import sys

import pytest

from conftest import REF_DATA, requires_ref_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, **kw):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "-m", "movi_tpu.cli"] + args,
                          cwd=REPO, env=env, capture_output=True,
                          text=True, **kw)


@requires_ref_data
def test_cli_build_query_golden(tmp_path):
    idx = str(tmp_path / "idx")
    r = _run(["build", "--fasta", os.path.join(REF_DATA, "ref.fasta"),
              "--index", idx, "--skip-null", "--verify"])
    assert r.returncode == 0, r.stderr
    r = _run(["query", "--index", idx,
              "--read", os.path.join(REF_DATA, "sample.fastq"),
              "--pml", "--stdout", "--platform", "cpu",
              "--no-paired-records"])
    assert r.returncode == 0, r.stderr
    assert "fused single-gather engine" in r.stderr
    got = sorted(r.stdout.splitlines(), key=str.encode)
    with open(os.path.join(REF_DATA, "sample.fastq.pmls.sorted")) as f:
        want = f.read().splitlines()
    assert got == want

    # capacity auto-selection takes the paired layout, which fits
    r = _run(["query", "--index", idx,
              "--read", os.path.join(REF_DATA, "sample.fastq"),
              "--pml", "--stdout", "--platform", "cpu"])
    assert r.returncode == 0, r.stderr
    assert "paired-record engine" in r.stderr
    assert sorted(r.stdout.splitlines(), key=str.encode) == want

    # forcing the paired layout still hits the same golden
    r = _run(["query", "--index", idx,
              "--read", os.path.join(REF_DATA, "sample.fastq"),
              "--pml", "--stdout", "--platform", "cpu",
              "--paired-records"])
    assert r.returncode == 0, r.stderr
    assert "paired-record engine" in r.stderr
    assert sorted(r.stdout.splitlines(), key=str.encode) == want


@requires_ref_data
def test_cli_sa_entries(tmp_path):
    idx = str(tmp_path / "idx")
    r = _run(["build", "--fasta", os.path.join(REF_DATA, "ref.fasta"),
              "--index", idx, "--skip-null", "--sa-entries"])
    assert r.returncode == 0, r.stderr
    reads = str(tmp_path / "reads.fa")
    with open(os.path.join(REF_DATA, "sample.fasta")) as f:
        content = f.read()
    with open(reads, "w") as f:
        f.write("\n".join(content.splitlines()[:4]) + "\n")
    r = _run(["query", "--index", idx, "--read", reads, "--pml",
              "--sa-entries", "--out-file", str(tmp_path / "o")])
    assert r.returncode == 0, r.stderr
    assert os.path.exists(str(tmp_path / "o") + ".pml.sa_entries.bpf")


def test_cli_multiclass_color_sources(tmp_path):
    """query --multi-classify gives identical CSVs whether colors come
    from colors.npz, the reference doc_sets binaries, or the embedded
    colored rows of index_colored.movi (load_color_table,
    movi.cpp:120-150)."""
    import numpy as np

    rng = np.random.default_rng(7)
    bases = "ACGT"
    fasta = str(tmp_path / "multi.fa")
    docs = ["".join(rng.choice(list(bases), size=900)) for _ in range(3)]
    with open(fasta, "w") as f:
        for i, d in enumerate(docs):
            f.write(f">doc{i}\n{d}\n")
    reads = str(tmp_path / "reads.fa")
    with open(reads, "w") as f:
        for k in range(8):
            i = int(rng.integers(0, 3))
            s = int(rng.integers(0, 800))
            f.write(f">r{k}\n{docs[i][s:s+90]}\n")

    idx = str(tmp_path / "idx")
    r = _run(["build", "--fasta", fasta, "--index", idx, "--skip-null",
              "--color"])
    assert r.returncode == 0, r.stderr
    for fn in ("colors.npz", "doc_pats.bin", "doc_sets.bin",
               "doc_sets_flat.bin"):
        assert os.path.exists(os.path.join(idx, fn)), fn
    r = _run(["color-move-rows", "--index", idx])
    assert r.returncode == 0, r.stderr

    def csv():
        out = str(tmp_path / "out")
        r = _run(["query", "--index", idx, "--read", reads,
                  "--pml", "--multi-classify", "--platform", "cpu",
                  "--out-file", out])
        assert r.returncode == 0, r.stderr
        with open(out) as f:
            return f.read()
    want = csv()
    assert len(want.splitlines()) == 8
    os.remove(os.path.join(idx, "colors.npz"))
    assert csv() == want          # from index_colored.movi + doc_sets.bin
    os.remove(os.path.join(idx, "index_colored.movi"))
    assert csv() == want          # from doc_sets.bin indices
    os.remove(os.path.join(idx, "doc_sets.bin"))
    assert csv() == want          # from doc_sets_flat.bin


@requires_ref_data
def test_cli_build_keep_resume(tmp_path):
    """build --keep persists the pipeline intermediates in reference
    formats; build --resume skips prepare_ref + suffix array and yields
    a bit-identical index (the launcher's --keep/--skip-* stage resume,
    movi_launcher.cpp:20-30)."""
    idx = str(tmp_path / "idx")
    r = _run(["build", "--fasta", os.path.join(REF_DATA, "ref.fasta"),
              "--index", idx, "--skip-null", "--keep"])
    assert r.returncode == 0, r.stderr
    for fn in ("ref.fa", "ref.fa.bwt.heads", "ref.fa.bwt.len",
               "ref.fa.thr_pos", "ref.fa.doc_offsets"):
        assert os.path.exists(os.path.join(idx, fn)), fn
    import numpy as np
    first = dict(np.load(os.path.join(idx, "index.npz")))
    os.remove(os.path.join(idx, "index.npz"))
    # resume: no --fasta needed, SA is not recomputed
    r = _run(["build", "--index", idx, "--skip-null", "--resume"])
    assert r.returncode == 0, r.stderr
    assert "resuming from kept intermediates" in r.stderr
    second = dict(np.load(os.path.join(idx, "index.npz")))
    assert sorted(first) == sorted(second)
    for k in first:
        assert np.array_equal(first[k], second[k]), k


@requires_ref_data
def test_cli_paired_cache(tmp_path):
    """build --paired-cache persists the composed paired records;
    query --paired-records loads them and hits the golden."""
    idx = str(tmp_path / "idx")
    r = _run(["build", "--fasta", os.path.join(REF_DATA, "ref.fasta"),
              "--index", idx, "--skip-null", "--paired-cache"])
    assert r.returncode == 0, r.stderr
    assert os.path.exists(os.path.join(idx, "paired_records.npz"))
    r = _run(["query", "--index", idx,
              "--read", os.path.join(REF_DATA, "sample.fastq"),
              "--pml", "--stdout", "--platform", "cpu",
              "--paired-records"])
    assert r.returncode == 0, r.stderr
    got = sorted(r.stdout.splitlines(), key=str.encode)
    with open(os.path.join(REF_DATA, "sample.fastq.pmls.sorted")) as f:
        assert got == f.read().splitlines()


def test_cli_count_duplicate_read_names(tmp_path):
    """Duplicate read NAMES are legal in fastq; each .matches line must
    report its own read's length (lengths pair positionally, not by
    name)."""
    import numpy as np

    rng = np.random.default_rng(3)
    ref = "".join(rng.choice(list("ACGT"), size=1200))
    fasta = str(tmp_path / "ref.fa")
    with open(fasta, "w") as f:
        f.write(f">r\n{ref}\n")
    reads = str(tmp_path / "reads.fa")
    with open(reads, "w") as f:
        f.write(f">dup\n{ref[100:160]}\n")   # length 60
        f.write(f">dup\n{ref[300:330]}\n")   # length 30

    idx = str(tmp_path / "idx")
    r = _run(["build", "--fasta", fasta, "--index", idx, "--skip-null"])
    assert r.returncode == 0, r.stderr
    out = str(tmp_path / "out")
    r = _run(["query", "--index", idx, "--read", reads, "--count",
              "--platform", "cpu", "--out-file", out])
    assert r.returncode == 0, r.stderr
    with open(out + ".count.matches") as f:
        lines = f.read().splitlines()
    assert len(lines) == 2
    # "name  matched/len  count": the len field must differ per read
    assert "/60" in lines[0].split()[1]
    assert "/30" in lines[1].split()[1]


@requires_ref_data
def test_cli_paired_search_parity(tmp_path):
    """count/zml --paired-records output is byte-identical to the
    one-step fused search engine's, and the build --paired-cache search
    records are picked up."""
    idx = str(tmp_path / "idx")
    r = _run(["build", "--fasta", os.path.join(REF_DATA, "ref.fasta"),
              "--index", idx, "--skip-null", "--paired-cache"])
    assert r.returncode == 0, r.stderr
    assert os.path.exists(os.path.join(idx, "paired_search_records.npz"))
    sample = os.path.join(REF_DATA, "sample.fastq")

    def counts(extra):
        out = str(tmp_path / "out")
        r = _run(["query", "--index", idx, "--read", sample, "--count",
                  "--platform", "cpu", "--out-file", out] + extra)
        assert r.returncode == 0, r.stderr
        with open(out + ".count.matches") as f:
            return f.read(), r.stderr
    want, err1 = counts(["--no-paired-records"])
    assert "fused search engine" in err1
    got, err = counts(["--paired-records"])
    assert "paired search engine" in err
    assert got == want

    def zml(extra):
        r = _run(["query", "--index", idx, "--read", sample, "--zml",
                  "--stdout", "--platform", "cpu"] + extra)
        assert r.returncode == 0, r.stderr
        return r.stdout
    assert zml(["--paired-records"]) == zml(["--no-paired-records"])
