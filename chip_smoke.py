#!/usr/bin/env python
"""End-to-end run of movi_tpu on one GPU, checked against the oracle.

    python chip_smoke.py                # one card, full size
    python chip_smoke.py --four         # only the multi-card path, 4 cards

One card: builds a seeded bacterial-species pangenome (a random 4 Mb base
genome, 4 haplotypes with 0.5% SNPs and 0.05% short indels, each
haplotype one document; `build` adds the reverse complements) through
`cli build --color` and `cli build-SA`.
Every query type then runs through `cli query` in this process, the way
a user calls it, and each device output is compared with the same
command run with --no-jax (the cpu_ref oracle) on a seeded sample of
reads.  Paired and one-step engines must agree on every read.

All outputs are integers and no engine computes a matrix product, so
every comparison is exact: the tolerance is zero and TF32 does not
arise.  Any mismatch or error ends the run with a non-zero exit code.

Each phase prints the engine chosen, wall time split into set-up (index
load, on-card compose, compile), device queries and output writing, and
the device's peak_bytes_in_use so far, beside the card's name and power
limit.  The last line of standard output is one JSON object naming the
device.
"""

from __future__ import annotations

import argparse
import filecmp
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from collections import defaultdict
from contextlib import redirect_stderr

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from movi_tpu import runtime  # noqa: E402

MODE = "regular-thresholds"
READ_LEN = 150
KMER_K = 31
MEM_L = 20
# the one-card data: a bacterial genome and its haplotypes (16 would
# give r ~ 15 M, whose host build and per-query set-up overrun the run's
# time limit; 4 give r ~ 8.7 M), reads per query type, oracle sample
BASE_LEN = 4_000_000
HAPLOTYPES = 4
READS = 200_000       # PML, count, ZML
TICK_READS = 20_000   # MEM, k-mers, SA entries, color
SAMPLE = 512
# the four-card check: a smaller index, one batch of reads
FOUR_BASE_LEN = 1_000_000
FOUR_HAPLOTYPES = 4
FOUR_LANES = 32768
WORK = os.path.join(HERE, ".smoke")  # gitignored; rebuilt on every run

# name, query flags, read set ("main" or "tick"), output kind
PHASES = [
    ("pml", ["--pml"], "main", "pml"),
    ("pml one-step", ["--pml", "--no-paired-records"], "main", "pml"),
    ("pml classify", ["--pml", "--classify"], "main", "report"),
    ("count", ["--count"], "main", "count"),
    ("count one-step", ["--count", "--no-paired-records"], "main",
     "count"),
    ("zml", ["--zml"], "main", "zml"),
    ("zml one-step", ["--zml", "--no-paired-records"], "main", "zml"),
    ("mem", ["--mem", "--min-mem-length", str(MEM_L)], "tick", "mems"),
    ("kmer", ["--kmer", "--k", str(KMER_K)], "tick", "kmers"),
    ("kmer-count", ["--kmer-count", "--k", str(KMER_K)], "tick",
     "kmers"),
    ("sa-entries", ["--pml", "--sa-entries"], "tick", "sa"),
    ("multi-classify", ["--pml", "--multi-classify"], "tick", "csv"),
]
# (paired phase, one-step phase): identical output over all reads
SAME_OUTPUT = [("pml", "pml one-step"), ("count", "count one-step"),
               ("zml", "zml one-step")]

_COMPILES: list = []  # (wall-clock end, seconds) of each JAX compile
_WATCHING: list = []


def _on_duration(event: str, duration: float, **_):
    if event.startswith("/jax/core/compile/"):
        _COMPILES.append((time.time(), duration))


def watch_compiles():
    """Record every JAX compile from now on (registered once)."""
    import jax.monitoring

    if not _WATCHING:
        jax.monitoring.register_event_duration_secs_listener(_on_duration)
        _WATCHING.append(True)


def compile_seconds(t0: float, t1: float) -> float:
    """Wall time within [t0, t1] during which JAX was compiling: the
    union of the recorded intervals (tracing nests inside compiles)."""
    total, upto = 0.0, t0
    for a, b in sorted((max(end - d, t0), min(end, t1))
                       for end, d in _COMPILES):
        a = max(a, upto)
        if b > a:
            total += b - a
            upto = b
    return total


def say(msg: str):
    print(msg, flush=True)


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_cli(argv) -> str:
    """cli.main(argv) in this process; returns what it logged.  Errors
    propagate (the CLI exits non-zero on a failed phase)."""
    from movi_tpu import cli, commons

    commons.SPANS.clear()
    _COMPILES.clear()
    buf = io.StringIO()
    with redirect_stderr(_Tee(sys.stderr, buf)):
        cli.main(argv)
    return buf.getvalue()


# ---------------------------------------------------------------- data


def make_data(work: str, seed: int, base_len: int, haplotypes: int,
              n_reads: int, n_tick: int, n_sample: int) -> dict:
    """Pangenome FASTA (one record per haplotype), read sets and the
    oracle sample, all from `seed`."""
    import numpy as np

    from movi_tpu import synth

    os.makedirs(work, exist_ok=True)
    haps = synth.pangenome(seed, base_len, haplotypes)
    d = {"fasta": os.path.join(work, "pangenome.fa"),
         "main": os.path.join(work, "reads.fq"),
         "tick": os.path.join(work, "reads_tick.fq"),
         "sample": os.path.join(work, "sample.fq")}
    synth.write_fasta(d["fasta"], [(f"hap{i}", h)
                                   for i, h in enumerate(haps)])
    reads = synth.sample_reads(haps, n_reads, READ_LEN, seed + 1)
    names = [f"r{i}" for i in range(n_reads)]
    synth.write_fastq(d["main"], names, reads)
    synth.write_fastq(d["tick"], names[:n_tick], reads[:n_tick])
    pick = np.sort(np.random.default_rng(seed + 2).choice(
        n_tick, size=n_sample, replace=False))
    synth.write_fastq(d["sample"], [names[i] for i in pick], reads[pick])
    d["sample_names"] = [names[i] for i in pick]
    d["n_reads"], d["n_tick"] = n_reads, n_tick
    d["text_bases"] = 2 * sum(len(h) for h in haps)
    return d


def build_index(work: str, data: dict) -> str:
    """`cli build --color` (each haplotype a document) and `build-SA`;
    returns the index directory."""
    import numpy as np

    from movi_tpu.engine import select

    idx = os.path.join(work, "index")
    shutil.rmtree(idx, ignore_errors=True)
    t0 = time.time()
    run_cli(["build", "--fasta", data["fasta"], "--index", idx,
             "--type", MODE, "--color"])
    t1 = time.time()
    run_cli(["build-SA", "--index", idx])
    t2 = time.time()
    z = np.load(os.path.join(idx, "index.npz"))
    n, r = (int(x) for x in z["meta"][:2])
    sigma = len(z["alphabet"])
    say(f"build: text_bases={n} r={r} n/r={n / r} build_s={t1 - t0} "
        f"build_sa_s={t2 - t1}")
    tables = {
        "one_step_pml": select.one_step_pml_table_bytes(r, sigma),
        "paired_pml": select.paired_pml_table_bytes(r, sigma),
        "one_step_search": select.one_step_search_table_bytes(r, sigma),
        "paired_search": select.paired_search_table_bytes(r, sigma)}
    say("table bytes: " + " ".join(f"{k}={v}" for k, v in tables.items()))
    return idx


# ------------------------------------------------------------- outputs


def output_path(kind: str, out: str, read_path: str) -> str:
    stem = f"{read_path}.{MODE}"
    return {"pml": f"{out}.pml.bpf", "zml": f"{out}.zml.bpf",
            "count": f"{out}.count.matches",
            "report": f"{stem}.pml.report", "mems": f"{stem}.mems",
            "kmers": f"{stem}.kmers.{KMER_K}",
            "sa": f"{out}.pml.sa_entries.bpf", "csv": out}[kind]


def read_output(kind: str, path: str, names) -> dict:
    """{read name: its output} for the reads in `names`."""
    from movi_tpu.io.outputs import read_bpf

    names = set(names)
    if kind in ("pml", "zml", "sa"):
        return {n: v for n, v in read_bpf(path) if n in names}
    got = defaultdict(list)
    with open(path) as f:
        for line in f:
            key = (line.split(",", 1)[0] if kind == "csv"
                   else line.split(None, 1)[0] if line.strip() else "")
            if key in names:
                got[key].append(line)
    return dict(got)


def query_phase(name: str, flags, read_set: str, kind: str, data: dict,
                idx: str, work: str, card: str) -> str:
    """Run one query on the device over its read set and with --no-jax
    on the sample; fail unless the sample's outputs are identical.
    Returns the device output file."""
    import jax

    from movi_tpu import commons

    tag = name.replace(" ", "_")
    reads = data[read_set]
    dev_out = os.path.join(work, f"out_{tag}")
    log = run_cli(["query", "--index", idx, "--read", reads,
                   "--out-file", dev_out] + flags)
    total0, total1 = commons.SPANS["query"]
    q0, q1 = commons.SPANS["device queries"]
    compile_s = compile_seconds(q0, q1)
    engines = re.findall(r"using the (.+)", log)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    dev_path = os.path.join(work, f"{tag}.device")
    shutil.move(output_path(kind, dev_out, reads), dev_path)
    n = data["n_reads"] if read_set == "main" else data["n_tick"]
    query_s = (q1 - q0) - compile_s
    say(f"phase {name}: engine={engines[-1] if engines else None!r} "
        f"reads={n} setup_s={(q0 - total0) + compile_s} "
        f"query_s={query_s} output_s={total1 - q1} "
        f"compile_s={compile_s} bases_per_s={n * READ_LEN / query_s} "
        f"peak_bytes_in_use={peak} card={card!r}")
    if not engines:
        raise SystemExit(f"phase {name}: no device engine ran")

    ora_out = os.path.join(work, f"oracle_{tag}")
    run_cli(["query", "--index", idx, "--read", data["sample"],
             "--out-file", ora_out, "--no-jax"] + flags)
    want = read_output(kind, output_path(kind, ora_out, data["sample"]),
                       data["sample_names"])
    got = read_output(kind, dev_path, data["sample_names"])
    if kind != "mems" and len(want) != len(data["sample_names"]):
        # every read has an output record in the other formats
        raise SystemExit(f"phase {name}: the oracle answered "
                         f"{len(want)} sampled reads")
    if got != want:
        bad = sorted(k for k in set(got) | set(want)
                     if got.get(k) != want.get(k))
        raise SystemExit(f"phase {name}: {len(bad)} of "
                         f"{len(data['sample_names'])} sampled reads "
                         f"differ from the oracle, e.g. {bad[:3]}")
    if kind == "sa":
        # the PML stream written beside the SA entries is checked too
        want = read_output("pml", f"{ora_out}.pml.bpf",
                           data["sample_names"])
        got = read_output("pml", f"{dev_out}.pml.bpf", data["sample_names"])
        if got != want:
            raise SystemExit(f"phase {name}: PMLs differ from the oracle")
    say(f"phase {name}: bit-exact with cpu_ref on "
        f"{len(data['sample_names'])} sampled reads")
    gc.collect()
    return dev_path


def run_one_card(work: str, data: dict, card: str):
    idx = build_index(work, data)
    outs = {ph[0]: query_phase(*ph, data=data, idx=idx, work=work,
                               card=card)
            for ph in PHASES}
    for a, b in SAME_OUTPUT:
        if not filecmp.cmp(outs[a], outs[b], shallow=False):
            raise SystemExit(f"{a} and {b} outputs differ")
        say(f"{a} == {b} on all {data['n_reads']} reads")


# ---------------------------------------------------------- four cards


def four_card_check(devices, seed: int, base_len: int, haplotypes: int,
                    lanes: int, card: str):
    """Data-parallel ShardedPMLEngine/ShardedSearchEngine over the four
    devices and the model-sharded record table (1 x 4 'data' x 'model'
    mesh), each compared bit-exactly with the one-card engines on the
    same reads.  The cards are joined all to all, so the mesh follows
    the algorithm alone."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from movi_tpu import synth
    from movi_tpu.build.suffix import build_bwt_runs
    from movi_tpu.engine.fused import FusedPMLEngine, build_fused_index
    from movi_tpu.engine.fused_search import (FusedCountEngine,
                                              FusedZMLEngine,
                                              build_fused_search_index)
    from movi_tpu.index.structure import build_move_index
    from movi_tpu.io.fastx import make_batches
    from movi_tpu.parallel.mesh import ShardedPMLEngine, ShardedSearchEngine
    from movi_tpu.parallel.sharded_index import (sharded_fused_count,
                                                 sharded_fused_pml,
                                                 sharded_fused_zml)

    t0 = time.time()
    haps = synth.pangenome(seed, base_len, haplotypes)
    text = np.concatenate([x for h in haps for x in (h, synth.revcomp(h))])
    ix = build_move_index(build_bwt_runs(text), MODE, bound_ff=1)
    fi = build_fused_index(ix)
    si = build_fused_search_index(ix)
    reads = synth.sample_reads(haps, lanes, READ_LEN, seed + 1)
    batch = next(make_batches([(f"r{i}", r.tobytes())
                               for i, r in enumerate(reads)], lanes=lanes))
    say(f"four: text_bases={len(text)} r={ix.r} lanes={lanes} "
        f"host_build_s={time.time() - t0}")

    want_pml = FusedPMLEngine(fi).query_batch(batch)
    want_cnt = FusedCountEngine(si).query_batch(batch)
    want_zml = FusedZMLEngine(si).query_batch(batch)
    L = batch.lengths

    def per_read(ml):
        ml = np.asarray(ml)
        return [ml[:int(L[i]), i].tolist() for i in range(lanes)]

    def timed(label, fn, want, conv):
        t = time.time()
        got = jax.block_until_ready(fn())
        first = time.time() - t
        if conv(got) != want:
            raise SystemExit(f"four: {label} differs from the one-card "
                             f"engine")
        t = time.time()
        jax.block_until_ready(fn())
        say(f"four: {label}: bit-exact with the one-card engine on "
            f"{lanes} reads; first_call_s={first} "
            f"second_call_s={time.time() - t} card={card!r}")

    dmesh = Mesh(np.array(devices), ("data",))
    for paired in (False, True):
        eng = ShardedPMLEngine(fi, mesh=dmesh, paired=paired)
        timed(f"data-parallel PML (paired={paired})",
              lambda: eng.query_batch_device(batch.seqs, batch.lengths)[0],
              want_pml, per_read)
    se = ShardedSearchEngine(si, mesh=dmesh)
    timed("data-parallel count",
          lambda: se.count_batch_device(batch.seqs, batch.lengths),
          want_cnt,
          lambda mc: [(int(L[i]) - int(m), int(c)) for i, (m, c)
                      in enumerate(zip(*(np.asarray(x) for x in mc)))])
    timed("data-parallel ZML",
          lambda: se.zml_batch_device(batch.seqs, batch.lengths),
          want_zml, per_read)

    mmesh = Mesh(np.array(devices).reshape(1, len(devices)),
                 ("data", "model"))
    proc = batch.seqs[:, ::-1]
    past = np.arange(batch.width)[None, :] >= L[:, None]
    a_pml = np.where(past, fi.sigma,
                     fi.alphamap_query[proc]).T.astype(np.int32)
    a_srch = np.where(past, -2,
                      si.alphamap_query[proc].astype(np.int32)).T
    timed("model-sharded PML",
          lambda: sharded_fused_pml(mmesh, fi, a_pml), want_pml, per_read)
    timed("model-sharded count",
          lambda: sharded_fused_count(mmesh, si, a_srch), want_cnt,
          lambda mc: [(int(L[i]) - int(m), int(c)) for i, (m, c)
                      in enumerate(zip(*(np.asarray(x) for x in mc)))])
    timed("model-sharded ZML",
          lambda: sharded_fused_zml(mmesh, si, a_srch), want_zml, per_read)


# ---------------------------------------------------------------- main


def ensure_native():
    """Build the C++ suffix-array / LF-sweep kernels the host build of a
    card-scale index needs (gitignored, so built in every checkout)."""
    subprocess.run(["make", "-C", os.path.join(HERE, "native")],
                   check=True, stdout=subprocess.DEVNULL)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the multi-card path, on 4 cards")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import jax

    runtime.require_gpu()
    facts = runtime.device_facts()
    want = 4 if args.four else 1
    if facts["count"] < want:
        raise SystemExit(f"needs {want} GPUs, JAX found {facts['count']}")
    card = runtime.card_name_and_power_limit()
    say(f"device: {facts['kind']} x{facts['count']} "
        f"(platform {facts['platform']})")
    say(f"nvidia-smi: {card}")
    card = card.splitlines()[0]
    say(f"compile cache: {runtime.enable_compile_cache()}")
    watch_compiles()

    if args.four:
        devices = jax.devices()[:4]
        four_card_check(devices, args.seed, FOUR_BASE_LEN, FOUR_HAPLOTYPES,
                        FOUR_LANES, card)
        facts["count"] = len(devices)
    else:
        ensure_native()
        shutil.rmtree(WORK, ignore_errors=True)
        t0 = time.time()
        data = make_data(WORK, args.seed, BASE_LEN, HAPLOTYPES, READS,
                         TICK_READS, SAMPLE)
        say(f"data: seed={args.seed} base_len={BASE_LEN} "
            f"haplotypes={HAPLOTYPES} text_bases={data['text_bases']} "
            f"reads={READS} tick_reads={TICK_READS} sample={SAMPLE} "
            f"read_len={READ_LEN} make_s={time.time() - t0}")
        run_one_card(WORK, data, card)
    print(json.dumps({"ok": True, "device": facts}), flush=True)


if __name__ == "__main__":
    main()
