"""FASTA/FASTQ reading (replacement for the reference's kseq.h +
batch_loader.cpp).  Host-side streaming feeds fixed-shape padded device
batches for the device engines."""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np


def _open_maybe_gz(path: str):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fastx_native(path: str):
    """Parse a FASTA/FASTQ file (plain or gz) with the C++ reader
    (native/movi_native.cpp movi_fastx_{scan,parse}), the production
    replacement for the reference's kseq.h: Python line parsing cannot
    keep up with the >200 Mbases/s device engines (SURVEY.md "Host I/O
    throughput").  Returns (names list, seqs uint8 concat, seq_offsets
    int64[n+1], lengths int32[n]) or None when the library is not built.
    """
    import ctypes

    from ..build.suffix import _load_native

    lib = _load_native()
    if not lib:
        return None
    if not hasattr(lib, "_fastx_ready"):
        lib.movi_fastx_scan.argtypes = [ctypes.c_char_p] + \
            [ctypes.POINTER(ctypes.c_int64)] * 3
        lib.movi_fastx_scan.restype = ctypes.c_int
        lib.movi_fastx_parse.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
        lib.movi_fastx_parse.restype = ctypes.c_int
        lib._fastx_ready = True
    n = ctypes.c_int64()
    sb = ctypes.c_int64()
    nb = ctypes.c_int64()
    p = path.encode()
    if lib.movi_fastx_scan(p, ctypes.byref(n), ctypes.byref(sb),
                           ctypes.byref(nb)) != 0:
        raise IOError(f"cannot read {path}")
    n, sb, nb = n.value, sb.value, nb.value
    seqs = np.empty(sb, dtype=np.uint8)
    seq_offsets = np.empty(n + 1, dtype=np.int64)
    lengths = np.empty(max(n, 1), dtype=np.int32)
    names_buf = ctypes.create_string_buffer(max(nb, 1))
    name_offsets = np.empty(n + 1, dtype=np.int64)
    rc = lib.movi_fastx_parse(
        p, seqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        seq_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        names_buf, name_offsets.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)))
    assert rc == 0
    raw_names = names_buf.raw
    names = [raw_names[name_offsets[i]:name_offsets[i + 1]].decode()
             for i in range(n)]
    return names, seqs, seq_offsets, lengths[:n]


def batches_from_file(path: str, lanes: int, reverse: bool = False,
                      bucket_widths: bool = True):
    """File -> padded ReadBatches with NO per-read Python objects: the
    C++ reader fills flat arrays, and the right-aligned [lanes, W] batch
    is assembled with one vectorized scatter per batch.  This is the
    production input path (the reference's BatchLoader + kseq,
    batch_loader.cpp:26-144).  Falls back to iter_fastx + make_batches
    when the native library is not built."""
    parsed = read_fastx_native(path)
    if parsed is None:
        yield from make_batches(list(iter_fastx(path, native=False)),
                                lanes=lanes, reverse=reverse,
                                bucket_widths=bucket_widths)
        return
    import ctypes

    from ..build.suffix import _load_native

    lib = _load_native()
    if not hasattr(lib, "_fastx_pack_ready"):
        lib.movi_fastx_pack.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        lib.movi_fastx_pack.restype = ctypes.c_int
        lib._fastx_pack_ready = True

    names, seqs, offs, lengths = parsed
    n = len(names)
    seqs_p = seqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    offs_p = offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    len_p = lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    for start in range(0, n, lanes):
        end = min(start + lanes, n)
        nl = end - start
        w = int(lengths[start:end].max()) if nl else 1
        if bucket_widths:
            w = _width_bucket(w)
        batch = np.empty((nl, w), dtype=np.uint8)
        rc = lib.movi_fastx_pack(
            seqs_p, offs_p, len_p, start, nl, w, int(reverse),
            batch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        assert rc == 0
        yield ReadBatch(names=names[start:end], seqs=batch,
                        lengths=np.minimum(lengths[start:end], w)
                        .astype(np.int32))


def iter_fastx(path: str, native: bool = True
               ) -> Iterator[Tuple[str, bytes]]:
    """Yield (read id, sequence bytes) from FASTA or FASTQ (optionally gz).

    Like kseq, the read id is the header token up to the first whitespace.
    Uses the C++ batched reader when built; falls back to Python parsing.
    """
    if native:
        parsed = read_fastx_native(path)
        if parsed is not None:
            names, seqs, offs, lengths = parsed
            blob = seqs.tobytes()
            for i, name in enumerate(names):
                yield name, blob[offs[i]:offs[i + 1]]
            return
    with _open_maybe_gz(path) as f:
        first = f.peek(1)[:1] if hasattr(f, "peek") else None
        line = f.readline()
        if not line:
            return
        if line.startswith(b"@"):
            # FASTQ
            while line:
                name = line[1:].rstrip(b"\r\n").split()[0].decode()
                seq = f.readline().rstrip(b"\r\n")
                f.readline()  # +
                f.readline()  # quals
                yield name, bytes(seq)
                line = f.readline()
        elif line.startswith(b">"):
            # FASTA (possibly multi-line)
            name = line[1:].rstrip(b"\r\n").split()[0].decode()
            chunks: List[bytes] = []
            for raw in f:
                s = raw.rstrip(b"\r\n")
                if s.startswith(b">"):
                    yield name, b"".join(chunks)
                    name = s[1:].split()[0].decode() if len(s) > 1 else ""
                    chunks = []
                else:
                    chunks.append(s)
            yield name, b"".join(chunks)
        else:
            raise ValueError(f"Unrecognized read file format: {path}")


@dataclass
class ReadBatch:
    """A fixed-shape padded batch of reads for the device engine.

    seqs[lane, pos] are raw byte values, right-aligned at column L-1 so the
    right-to-left scan starts at the same column for every lane; positions
    before a read's start hold 255 (padding).
    """

    names: List[str]
    seqs: np.ndarray     # uint8 [lanes, L]
    lengths: np.ndarray  # int32 [lanes]

    @property
    def lanes(self) -> int:
        return self.seqs.shape[0]

    @property
    def width(self) -> int:
        return self.seqs.shape[1]


PAD_BYTE = 255


def _width_bucket(w: int) -> int:
    """Round the batch width up to a small set of buckets so jit compiles
    stay bounded across variable-length read files (nanopore etc.)."""
    if w <= 64:
        return 64
    b = 64
    while b < w:
        b += b // 2 if b >= 256 else b  # 64,128,256,384,576,864,...
    return b


def make_batches(reads: List[Tuple[str, bytes]], lanes: int,
                 width: int | None = None, reverse: bool = False,
                 bucket_widths: bool = True) -> Iterator[ReadBatch]:
    """Pack reads into padded [lanes, width] batches (right-aligned)."""
    for start in range(0, len(reads), lanes):
        chunk = reads[start : start + lanes]
        w = width or max(len(s) for _, s in chunk)
        if width is None and bucket_widths:
            w = _width_bucket(w)
        nlanes = lanes if width else len(chunk)
        seqs = np.full((nlanes, w), PAD_BYTE, dtype=np.uint8)
        lengths = np.zeros(nlanes, dtype=np.int32)
        names = []
        for i, (name, s) in enumerate(chunk):
            if reverse:
                s = s[::-1]
            b = np.frombuffer(s, dtype=np.uint8)[:w]
            seqs[i, w - len(b):] = b
            lengths[i] = len(b)
            names.append(name)
        yield ReadBatch(names=names, seqs=seqs, lengths=lengths)


def left_aligned_slots(batch: ReadBatch, amap, fill: int = -2):
    """Vectorized [lanes, W] alphabet slots in READ order (left-aligned)
    from a right-aligned batch: one fancy-indexed gather instead of a
    32k-iteration Python loop (the loop cost seconds per batch at full
    lane counts).  Positions past a read's length hold `fill`."""
    import numpy as np

    W = batch.width
    lanes = batch.lanes
    mapped = amap[batch.seqs]                      # [lanes, W]
    shift = (W - batch.lengths.astype(np.int64))[:, None]
    idx = np.arange(W, dtype=np.int64)[None, :] + shift
    valid = idx < W
    out = np.where(
        valid,
        mapped[np.arange(lanes)[:, None], np.minimum(idx, W - 1)],
        fill)
    return out.astype(np.int32)
