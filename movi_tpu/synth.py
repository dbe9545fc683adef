"""Seeded synthetic pangenomes and reads.

A pangenome here is what a bacterial-species index holds: haplotypes
derived from one random base genome by SNPs and short indels.  Reads are
fixed-length substrings of the haplotypes (either strand) with
substitution errors, mixed with uniformly random reads that the index
should not contain.  Everything is drawn from one numpy Generator, so a
seed reproduces the data exactly.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
_CODE = np.zeros(256, np.int64)
_CODE[ACGT] = np.arange(4)
_COMP = np.zeros(256, np.uint8)
_COMP[ACGT] = np.frombuffer(b"TGCA", np.uint8)


def revcomp(seq: np.ndarray) -> np.ndarray:
    return _COMP[seq[::-1]]


def _substitute(seq: np.ndarray, where: np.ndarray,
                rng: np.random.Generator) -> np.ndarray:
    """Replace seq[where] by a different base, drawn uniformly."""
    old = seq[where]
    return ACGT[(_CODE[old] + rng.integers(1, 4, size=old.shape)) % 4]


def mutate(base: np.ndarray, rng: np.random.Generator, snp_rate: float,
           indel_rate: float, max_indel: int = 3) -> np.ndarray:
    """One haplotype: SNPs at snp_rate per base, then insertions and
    deletions of 1..max_indel bases at indel_rate per base."""
    n = len(base)
    hap = base.copy()
    snp = rng.random(n) < snp_rate
    hap[snp] = _substitute(hap, snp, rng)
    sites = np.flatnonzero(rng.random(n) < indel_rate)
    lens = rng.integers(1, max_indel + 1, size=len(sites))
    ins = rng.random(len(sites)) < 0.5
    # deleted bases are marked 0 and dropped after the insertions, so
    # both kinds are placed in base coordinates
    for s, ln in zip(sites[~ins], lens[~ins]):
        hap[s:s + ln] = 0
    at = np.repeat(sites[ins], lens[ins])
    hap = np.insert(hap, at, ACGT[rng.integers(0, 4, size=len(at))])
    return hap[hap != 0]


def pangenome(seed: int, base_len: int, haplotypes: int,
              snp_rate: float = 0.005, indel_rate: float = 0.0005
              ) -> List[np.ndarray]:
    """`haplotypes` mutated copies of one random base genome."""
    rng = np.random.default_rng(seed)
    base = ACGT[rng.integers(0, 4, size=base_len)]
    return [mutate(base, rng, snp_rate, indel_rate)
            for _ in range(haplotypes)]


def sample_reads(haps: Sequence[np.ndarray], n: int, read_len: int,
                 seed: int, err_rate: float = 0.01,
                 present_frac: float = 0.5) -> np.ndarray:
    """uint8 [n, read_len]: a present_frac share drawn from the
    haplotypes (either strand, err_rate substitutions), the rest
    uniformly random; rows in shuffled order."""
    rng = np.random.default_rng(seed)
    n_in = int(n * present_frac)
    lens = np.array([len(h) for h in haps])
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cat = np.concatenate(haps)
    hid = rng.integers(0, len(haps), size=n_in)
    starts = offs[hid] + (rng.random(n_in)
                          * (lens[hid] - read_len + 1)).astype(np.int64)
    found = cat[starts[:, None] + np.arange(read_len)]
    rc = rng.random(n_in) < 0.5
    found[rc] = _COMP[found[rc, ::-1]]
    err = rng.random(found.shape) < err_rate
    found[err] = _substitute(found, err, rng)
    rand = ACGT[rng.integers(0, 4, size=(n - n_in, read_len))]
    reads = np.concatenate([found, rand])
    return reads[rng.permutation(n)]


def write_fasta(path: str, records: Sequence[Tuple[str, np.ndarray]]):
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name.encode() + b"\n" + seq.tobytes() + b"\n")


def write_fastq(path: str, names: Sequence[str], reads: np.ndarray):
    qual = b"I" * reads.shape[1]
    with open(path, "wb") as f:
        f.write(b"".join(
            b"@" + name.encode() + b"\n" + row.tobytes() + b"\n+\n"
            + qual + b"\n" for name, row in zip(names, reads)))
