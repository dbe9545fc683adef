"""Multi-host runtime: byte-range read sharding and a real 2-process
jax.distributed run whose merged outputs are byte-identical to 1 host
(the distributed analogue of the reference's OpenMP merge,
movi.cpp:274-386)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from conftest import REF_DATA, requires_ref_data

from movi_tpu.parallel.multihost import byte_range_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, (name, seq) in enumerate(reads):
            # quality lines intentionally starting with '@' exercise the
            # record-boundary disambiguation of _find_record_start
            q0 = "@" if i % 3 == 0 else "I"
            f.write(f"@{name}\n{seq}\n+\n{q0 * len(seq)}\n")


def _mkreads(n, rng):
    bases = "ACGT"
    return [(f"r{i}", "".join(rng.choice(list(bases),
                                         size=int(rng.integers(40, 90)))))
            for i in range(n)]


@pytest.mark.parametrize("num_hosts", [1, 2, 3, 4])
def test_byte_range_fastq(tmp_path, num_hosts):
    rng = np.random.default_rng(3)
    reads = _mkreads(23, rng)
    path = str(tmp_path / "reads.fastq")
    _write_fastq(path, reads)
    got = []
    for h in range(num_hosts):
        got.extend((n, s.decode()) for n, s in
                   byte_range_reads(path, num_hosts, h))
    assert got == reads


@pytest.mark.parametrize("num_hosts", [1, 2, 3])
def test_byte_range_fasta_multiline(tmp_path, num_hosts):
    rng = np.random.default_rng(4)
    reads = _mkreads(17, rng)
    path = str(tmp_path / "reads.fa")
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n")
            for k in range(0, len(seq), 25):   # multi-line records
                f.write(seq[k:k + 25] + "\n")
    got = []
    for h in range(num_hosts):
        got.extend((n, s.decode()) for n, s in
                   byte_range_reads(path, num_hosts, h))
    assert got == reads


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(args):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "movi_tpu.parallel.multihost"] + args,
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@requires_ref_data
def test_two_process_distributed_merge(tmp_path):
    """Spawn a real 2-process jax.distributed CPU run; the merged .bpf
    and .report must be byte-identical to a 1-host run."""
    # build a small index + nulldb once (subprocess, scalar path)
    idx = str(tmp_path / "idx")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "movi_tpu.cli", "build",
         "--fasta", os.path.join(REF_DATA, "ref.fasta"), "--index", idx],
        cwd=REPO, env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr

    reads = os.path.join(REF_DATA, "sample.fastq")

    def run(num_hosts, tag):
        prefix = str(tmp_path / tag)
        port = _free_port()
        procs = [
            _launch(["--coordinator", f"127.0.0.1:{port}",
                     "--num-hosts", str(num_hosts), "--host-id", str(h),
                     "--index", idx, "--read", reads, "--pml",
                     "--classify", "--platform", "cpu",
                     "--out-prefix", prefix])
            for h in range(num_hosts)
        ]
        for p in procs:
            out, err = p.communicate(timeout=420)
            assert p.returncode == 0, err
        return prefix

    p1 = run(1, "one")
    p2 = run(2, "two")
    with open(p1 + ".bpf", "rb") as f:
        b1 = f.read()
    with open(p2 + ".bpf", "rb") as f:
        b2 = f.read()
    assert b1 == b2
    with open(p1 + ".report") as f:
        r1 = f.read()
    with open(p2 + ".report") as f:
        r2 = f.read()
    assert r1 == r2
    assert len(r1.splitlines()) > 1
    # shards were cleaned up after the merge
    assert not os.path.exists(p2 + ".bpf.part0")


@pytest.mark.parametrize("num_hosts", [2, 3])
def test_byte_range_gz_preserves_order(tmp_path, num_hosts):
    """Gzipped inputs shard into CONTIGUOUS blocks so the host-order
    merge still restores file order (regression: round-robin scrambled
    the merged output)."""
    import gzip

    rng = np.random.default_rng(6)
    reads = _mkreads(19, rng)
    path = str(tmp_path / "reads.fastq.gz")
    body = "".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in reads)
    with gzip.open(path, "wt") as f:
        f.write(body)
    got = []
    for h in range(num_hosts):
        got.extend((n, s.decode()) for n, s in
                   byte_range_reads(path, num_hosts, h))
    assert got == reads


def test_two_process_count_and_multiclass_merge(tmp_path):
    """The multihost runtime covers every query type (movi.cpp:274-386):
    2-process count .matches and multi-class CSV merges are
    byte-identical to 1-host runs, and the cross-process class counters
    agree with the CSV."""
    rng = np.random.default_rng(17)
    bases = "ACGT"
    fasta = str(tmp_path / "multi.fa")
    docs = ["".join(rng.choice(list(bases), size=800)) for _ in range(3)]
    with open(fasta, "w") as f:
        for i, d in enumerate(docs):
            f.write(f">doc{i}\n{d}\n")
    idx = str(tmp_path / "idx")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "movi_tpu.cli", "build",
         "--fasta", fasta, "--index", idx, "--skip-null", "--color"],
        cwd=REPO, env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr

    reads_path = str(tmp_path / "reads.fastq")
    reads = []
    for k in range(12):
        i = int(rng.integers(0, 3))
        s = int(rng.integers(0, 700))
        reads.append((f"r{k}", docs[i][s:s + 80]))
    _write_fastq(reads_path, reads)

    def run(num_hosts, tag, flag):
        prefix = str(tmp_path / tag)
        port = _free_port()
        procs = [
            _launch(["--coordinator", f"127.0.0.1:{port}",
                     "--num-hosts", str(num_hosts), "--host-id", str(h),
                     "--index", idx, "--read", reads_path, flag,
                     "--platform", "cpu", "--out-prefix", prefix])
            for h in range(num_hosts)
        ]
        for p in procs:
            out, err = p.communicate(timeout=420)
            assert p.returncode == 0, err
        return prefix

    # count
    p1 = run(1, "c_one", "--count")
    p2 = run(2, "c_two", "--count")
    with open(p1 + ".matches") as f:
        m1 = f.read()
    with open(p2 + ".matches") as f:
        m2 = f.read()
    assert m1 == m2
    assert len(m1.splitlines()) == len(reads)

    # multi-classify
    p1 = run(1, "m_one", "--multi-classify")
    p2 = run(2, "m_two", "--multi-classify")
    with open(p1 + ".multiclass.csv") as f:
        c1 = f.read()
    with open(p2 + ".multiclass.csv") as f:
        c2 = f.read()
    assert c1 == c2
    assert len(c1.splitlines()) == len(reads)


def test_two_process_mems_and_kmers_merge(tmp_path):
    """MEM finding and exact k-mer counts run under the same multihost
    runtime: 2-process merged outputs byte-identical to 1-host runs
    (completing the movi.cpp:274-386 every-query-type surface)."""
    rng = np.random.default_rng(23)
    bases = "ACGT"
    fasta = str(tmp_path / "ref.fa")
    doc = "".join(rng.choice(list(bases), size=2500))
    with open(fasta, "w") as f:
        f.write(f">doc\n{doc}\n")
    idx = str(tmp_path / "idx")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "movi_tpu.cli", "build",
         "--fasta", fasta, "--index", idx, "--skip-null"],
        cwd=REPO, env=env, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr

    reads_path = str(tmp_path / "reads.fastq")
    reads = []
    for k in range(10):
        s = int(rng.integers(0, 2400))
        seq = list(doc[s:s + 70])
        if k % 2:  # mismatches break up the MEMs
            for pos in rng.integers(0, 70, size=3):
                seq[int(pos)] = bases[int(rng.integers(0, 4))]
        reads.append((f"r{k}", "".join(seq)))
    _write_fastq(reads_path, reads)

    def run(num_hosts, tag, *flags):
        prefix = str(tmp_path / tag)
        port = _free_port()
        procs = [
            _launch(["--coordinator", f"127.0.0.1:{port}",
                     "--num-hosts", str(num_hosts), "--host-id", str(h),
                     "--index", idx, "--read", reads_path, *flags,
                     "--platform", "cpu", "--out-prefix", prefix])
            for h in range(num_hosts)
        ]
        for p in procs:
            out, err = p.communicate(timeout=420)
            assert p.returncode == 0, err
        return prefix

    p1 = run(1, "mem_one", "--mems", "--min-mem-length", "12")
    p2 = run(2, "mem_two", "--mems", "--min-mem-length", "12")
    with open(p1 + ".mems") as f:
        m1 = f.read()
    with open(p2 + ".mems") as f:
        m2 = f.read()
    assert m1 == m2
    assert len(m1.splitlines()) >= len(reads)

    p1 = run(1, "km_one", "--kmers", "--k", "21")
    p2 = run(2, "km_two", "--kmers", "--k", "21")
    with open(p1 + ".kmers.21") as f:
        k1 = f.read()
    with open(p2 + ".kmers.21") as f:
        k2 = f.read()
    assert k1 == k2
    assert len(k1.splitlines()) == len(reads)
    # exact counts: every clean read's k-mers all occur at least once
    for ln in k1.splitlines():
        name, frac, total = ln.split("\t")
        if int(name[1:]) % 2 == 0:
            a, b = frac.split("/")
            assert a == b and int(total) >= int(b)


@pytest.mark.parametrize("ids", [None, [2]])
def test_initialize_passes_local_device_ids(monkeypatch, ids):
    """initialize pins a process to its own cards on a multi-card
    machine (jax.distributed.initialize(local_device_ids=...))."""
    import jax

    from movi_tpu.parallel import multihost

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    multihost.initialize("localhost:1234", 4, 2, local_device_ids=ids)
    assert seen == {"coordinator_address": "localhost:1234",
                    "num_processes": 4, "process_id": 2,
                    "local_device_ids": ids}
