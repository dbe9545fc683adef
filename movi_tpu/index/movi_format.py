"""Reference-compatible `index.movi` serialization.

Byte-layout mirror of src/move_structure_io.cpp (serialize :435-469,
write_* helpers) and the per-mode packed MoveRow layouts
(include/move_row.hpp, include/move_row_configs.hpp, src/move_row.cpp).
The emitted files match the reference's exact byte sizes (the contract of
tests/test_build.cpp) and the documented field semantics; padding and
fields the reference leaves unset are zeroed.

All 9 reference modes serialize byte-size-exactly and read back:
large(0), constant(1), blocked(2), regular(3), split(4), sampled(5),
regular-thresholds(6), sampled-thresholds(7), blocked-thresholds(8).
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

from ..constants import MODE_INFO
from .structure import MoveIndex

MOVI_MAGIC = 0x4D4F5649
VERSION = (2, 0, 0)

TALLY_CHECKPOINTS = 20
BLOCK_SIZE = {2: 1 << 22, 8: 1 << 20}
MAX_BLOCKED_ID = {2: (1 << 24) - 1, 8: (1 << 22) - 1}


def _thr_bits(ix: MoveIndex):
    """Per-row 1-bit thresholds for split-threshold modes: bit = 1 iff
    the stored value equals n (move_structure_build.cpp:869-878)."""
    thr = ix.thr
    n = ix.n_arr.astype(np.int64)[:, None]
    bits = (thr.astype(np.int64) >= n).astype(np.uint16)
    inside = (thr > 0) & (thr < n)
    if np.any(inside):
        raise ValueError("non-boundary threshold in a split-thresholds mode")
    return bits  # [r, 3]


def _header_bytes(mode_num: int, ix: MoveIndex) -> bytes:
    h = struct.pack("<IBBB", MOVI_MAGIC, *VERSION)
    h += struct.pack("<BB", mode_num, 0)  # type, reserved
    h += b"\x00" * 7      # struct padding to 8-byte alignment
    h += struct.pack("<QQQQ", ix.length, ix.r, ix.original_r, ix.end_bwt_idx)
    assert len(h) == 48
    return h


def _basic_bytes(ix: MoveIndex, nt_splitting: int = 0,
                 constant: int = 0) -> bytes:
    out = bytearray()
    end_thr = np.zeros(4, dtype="<u8")
    for j in range(min(4, len(ix.end_bwt_idx_thresholds))):
        end_thr[j] = ix.end_bwt_idx_thresholds[j]
    out += end_thr.tobytes()
    out += np.zeros(4, dtype="<u8").tobytes()  # end_bwt_idx_next_down
    out += np.zeros(4, dtype="<u8").tobytes()  # end_bwt_idx_next_up
    out += struct.pack("<Q", 256)
    out += ix.alphamap.astype("<u8").tobytes()
    out += struct.pack("<Q", ix.sigma)
    out += ix.alphabet.tobytes()
    out += struct.pack("<H", nt_splitting)
    out += struct.pack("<B", constant)
    return bytes(out)


def _overflow_bytes(n_overflow=(), offset_overflow=(),
                    thr_overflow=None) -> bytes:
    """write_overflow_tables (move_structure_io.cpp:185-199): three
    u64-counted sections.  n/offset entries are u64 escape values; each
    thresholds entry is (sigma-1) u64 values for one overflowed row."""
    out = bytearray()
    out += struct.pack("<Q", len(n_overflow))
    out += np.asarray(n_overflow, dtype="<u8").tobytes()
    out += struct.pack("<Q", len(offset_overflow))
    out += np.asarray(offset_overflow, dtype="<u8").tobytes()
    k = 0 if thr_overflow is None else len(thr_overflow)
    out += struct.pack("<Q", k)
    if k:
        out += np.asarray(thr_overflow, dtype="<u8").tobytes()
    return bytes(out)


def _read_overflow_tables(f, n_thr_slots: int):
    """Counterpart of read_overflow_tables (move_structure_io.cpp:218-249).
    Returns (n_overflow, offset_overflow, thr_overflow[k, n_thr_slots])."""
    (ns,) = struct.unpack("<Q", f.read(8))
    n_ovf = np.frombuffer(f.read(ns * 8), dtype="<u8").astype(np.int64)
    (os_,) = struct.unpack("<Q", f.read(8))
    off_ovf = np.frombuffer(f.read(os_ * 8), dtype="<u8").astype(np.int64)
    (ts,) = struct.unpack("<Q", f.read(8))
    thr_ovf = np.frombuffer(f.read(ts * n_thr_slots * 8),
                            dtype="<u8").astype(np.int64)
    return n_ovf, off_ovf, thr_ovf.reshape(ts, n_thr_slots)


def _counts_bytes(ix: MoveIndex) -> bytes:
    out = bytearray()
    out += struct.pack("<Q", ix.sigma)
    out += ix.counts.astype("<u8").tobytes()
    out += struct.pack("<Q", ix.sigma + 1)
    out += ix.last_runs.astype("<u8").tobytes()
    out += ix.last_offsets.astype("<u8").tobytes()
    out += ix.first_runs.astype("<u8").tobytes()
    out += ix.first_offsets.astype("<u8").tobytes()
    return bytes(out)


def _next_pointer_fields(ix: MoveIndex):
    """Constant-mode next_up/next_down u16 deltas per threshold slot
    (compute_nexts, move_structure_build.cpp:1080-1118)."""
    from ..constants import ALPHAMAP_3

    r, sigma = ix.r, ix.sigma
    nu, nd = ix.next_tables()
    ups = np.full((r, 3), 0xFFFF, dtype=np.uint16)
    downs = np.full((r, 3), 0xFFFF, dtype=np.uint16)
    idxs = np.arange(r)
    c_eff = ix.c_arr.astype(np.int64)
    for j in range(sigma):
        up = np.full(r, r, dtype=np.int64)
        dn = np.full(r, r, dtype=np.int64)
        up[1:] = nu[j, :-1]
        dn[:-1] = nd[j, 1:]
        slot = ALPHAMAP_3[c_eff, j]
        store = (slot < 3) & (idxs != ix.end_bwt_idx)
        du = np.where(up < r, idxs - up, 0xFFFF)
        dd = np.where(dn < r, dn - idxs, 0xFFFF)
        for s in range(3):
            m = store & (slot == s)
            ups[m, s] = np.minimum(du[m], 0xFFFF).astype(np.uint16)
            downs[m, s] = np.minimum(dd[m], 0xFFFF).astype(np.uint16)
    return ups, downs


def _sep_row_mask(ix: MoveIndex) -> np.ndarray:
    from ..constants import SEPARATOR
    if not ix.separators:
        return np.zeros(ix.r, dtype=bool)
    m = ix.alphabet[ix.c_arr] == SEPARATOR
    m[ix.end_bwt_idx] = False  # '$' row stores c = alphabet index 0
    return m


def _rows_movi1(ix: MoveIndex, constant: bool = False):
    """Large/split 12B rows: id u32 | n u16 | offset u16 | threshold u16 |
    overflow_bits u8 | thresholds_status u8.  Constant rows append
    next_up[3] + next_down[3] u16 (24B total).

    A row whose 3 thresholds hold >= 2 DISTINCT non-trivial values (not 0,
    not n) cannot be packed into the single u16 threshold field: its exact
    values spill to the thresholds_overflow table and the row stores the
    table index through the status machinery with overflow bit 6 CLEARED
    (the reference's bit convention is inverted: a cleared bit means
    overflow, move_row.hpp:202-205).  This mirrors the reference's intent
    (move_structure_build.cpp:892-903); the reference's own writer
    mis-flags these rows (`rlbwt[i]` for `rlbwt[idx]` in
    set_rlbwt_thresholds, move_row getters resolve via
    thresholds_overflow[stored_index] either way), so we implement the
    documented resolution path, which the reference reader
    (move_structure.cpp:328-335) decodes exactly.

    Returns (bytes, thr_overflow int64[k, 3])."""
    r = ix.r
    if int(ix.n_arr.max()) > 0xFFFF or int(ix.offset_arr.max()) > 0xFFFF:
        raise ValueError(
            "run length or offset exceeds the 16-bit row field; the "
            "reference build raises here too (move_structure_build.cpp:625)"
            " -- rebuild with run splitting")
    if constant:
        rows = np.zeros(r, dtype=[("id", "<u4"), ("n", "<u2"), ("off", "<u2"),
                                  ("thr", "<u2"), ("ovf", "u1"), ("ts", "u1"),
                                  ("nup", "<u2", (3,)), ("ndown", "<u2", (3,))])
        ups, downs = _next_pointer_fields(ix)
        rows["nup"] = ups
        rows["ndown"] = downs
    else:
        rows = np.zeros(r, dtype=[("id", "<u4"), ("n", "<u2"), ("off", "<u2"),
                                  ("thr", "<u2"), ("ovf", "u1"), ("ts", "u1")])
    rows["id"] = ix.id_arr & 0xFFFFFFFF
    rows["n"] = ix.n_arr
    rows["off"] = ix.offset_arr
    ovf = (0xF0 | ((ix.id_arr >> 32) & 0x0F)).astype(np.uint8)
    ts = np.zeros(r, dtype=np.uint16)
    thr16 = np.zeros(r, dtype=np.uint16)
    thr_overflow = np.zeros((0, 3), dtype=np.int64)
    if ix.thr is not None:
        n64 = ix.n_arr.astype(np.int64)
        v = ix.thr.astype(np.int64)                      # [r, 3]
        nontrivial = (v > 0) & (v < n64[:, None])
        # only the first sigma-1 slots hold real thresholds (one per
        # non-row character, alphamap_3); ignore unused slots
        nontrivial &= (np.arange(3) < max(1, ix.sigma - 1))[None, :]
        vmax = np.where(nontrivial, v, np.int64(-1)).max(axis=1)
        vmin = np.where(nontrivial, v, np.iinfo(np.int64).max).min(axis=1)
        multi = (nontrivial.sum(axis=1) >= 2) & (vmax != vmin)
        multi[ix.end_bwt_idx] = False   # stored in end_bwt_idx_thresholds
        multi[0] = False                # row 0 thresholds are forced to 0
        multi[_sep_row_mask(ix)] = False  # stored in separators_thresholds
        for slot in range(3):
            vs = v[:, slot]
            status = np.where(vs == 0, 0, np.where(vs >= n64, 3, 1))
            ts |= (status.astype(np.uint16) << (slot * 2))
            thr16 = np.where(status == 1, vs.astype(np.uint16), thr16)
        over_rows = np.flatnonzero(multi)[::-1]  # reference push order:
        if len(over_rows):                       # i = r-1 down to 1
            # entries are (sigma-1) u64 each (write_overflow_tables,
            # move_structure_io.cpp:197-199): pad/trim the 3 stored
            # threshold slots to the alphabet width
            width = max(1, ix.sigma - 1)
            thr_overflow = np.zeros((len(over_rows), width),
                                    dtype=np.int64)
            take = min(3, width)
            thr_overflow[:, :take] = v[over_rows][:, :take]
            if len(over_rows) >= 0xFFFF:
                raise ValueError(
                    "more than uint16 rows with overflow thresholds "
                    "(move_structure_build.cpp:894)")
            ovf[over_rows] &= ~np.uint8(0x40)    # clear bit 6 = overflow
            tab = np.arange(len(over_rows), dtype=np.int64)
            st = np.where(tab == 0, 0, np.where(tab == n64[over_rows], 3, 1))
            ts_over = (st | (st << 2) | (st << 4)).astype(np.uint16)
            ts[over_rows] = ts_over
            thr16[over_rows] = np.where(st == 1, tab, 0).astype(np.uint16)
    ts |= (ix.c_arr.astype(np.uint16) << 6) & 0xC0
    # '$' row: stored c bits are 0 (masked set_c), matching c_arr[end]=0
    rows["thr"] = thr16
    rows["ts"] = ts.astype(np.uint8)
    rows["ovf"] = ovf
    return rows.tobytes(), thr_overflow


def _check_run_fields(ix: MoveIndex, max_run: int):
    """SPLIT_MAX_RUN modes raise when a run field exceeds its packed
    width (move_structure_build.cpp:612-617) -- values are never masked
    silently."""
    if int(ix.n_arr.max()) > max_run or int(ix.offset_arr.max()) > max_run:
        raise ValueError(
            f"run length {int(ix.n_arr.max())} / offset "
            f"{int(ix.offset_arr.max())} exceeds the mode's "
            f"MAX_RUN_LENGTH {max_run}; rebuild with run splitting "
            f"(the reference raises here too)")


def _rows_regular(ix: MoveIndex, with_thr: bool) -> bytes:
    """Regular(-thresholds) 8B rows: id u32 | n u16 | offset u16
    (move_row_configs.hpp:20-51)."""
    r = ix.r
    shift_c = 13
    len_bits = 11 if with_thr else 12
    _check_run_fields(ix, (1 << len_bits) - 1)
    nfield = (ix.n_arr.astype(np.uint32) & ((1 << len_bits) - 1)) | \
             (ix.c_arr.astype(np.uint32) << shift_c)
    ofield = (ix.offset_arr.astype(np.uint32) & ((1 << len_bits) - 1)) | \
             (((ix.id_arr >> 32) & 0xF).astype(np.uint32) << 12)
    if with_thr:
        bits = _thr_bits(ix)
        ofield |= bits[:, 0].astype(np.uint32) << 11   # SHIFT_THRESHOLD_1
        nfield |= bits[:, 1].astype(np.uint32) << 11   # SHIFT_THRESHOLD_2
        nfield |= bits[:, 2].astype(np.uint32) << 12   # SHIFT_THRESHOLD_3
    rows = np.zeros(r, dtype=[("id", "<u4"), ("n", "<u2"), ("off", "<u2")])
    rows["id"] = ix.id_arr & 0xFFFFFFFF
    rows["n"] = nfield.astype(np.uint16)
    rows["off"] = ofield.astype(np.uint16)
    return rows.tobytes()


def _blocked_ids(ix: MoveIndex, mode_num: int):
    """compute_blocked_ids (move_structure_build.cpp:939-1074)."""
    r = ix.r
    block_size = BLOCK_SIZE[mode_num]
    max_allowed = MAX_BLOCKED_ID[mode_num]
    ids = ix.id_arr.astype(np.int64)
    c = ix.c_arr.astype(np.int64)
    first_runs = ix.first_runs.astype(np.int64)
    from ..commons import ProgressBar

    while True:
        nblocks = (r + block_size - 1) // block_size
        id_blocks = np.zeros((ix.sigma, nblocks), dtype=np.uint32)
        blocked = np.zeros(r, dtype=np.int64)
        start_id = np.zeros(ix.sigma, dtype=np.int64)
        ok = True
        bar = ProgressBar(nblocks, "computing blocked ids")
        for b in range(nblocks):
            bar.update(b)
            id_blocks[:, b] = start_id
            lo, hi = b * block_size, min((b + 1) * block_size, r)
            for i in range(lo, hi):
                if i == ix.end_bwt_idx:
                    continue
                adj = ids[i] - first_runs[c[i] + 1]
                bid = adj - int(id_blocks[c[i], b])
                if bid > max_allowed:
                    ok = False
                    break
                blocked[i] = bid
                start_id[c[i]] = adj
            if not ok:
                break
        bar.done()
        if ok:
            return blocked, id_blocks, block_size
        block_size //= 2
        max_allowed = (max_allowed + 1) // 2 - 1


def _rows_blocked(ix: MoveIndex, mode_num: int):
    """Blocked 6B rows: id u16 | n u16 | offset u16."""
    _check_run_fields(ix, 0x3FF)
    blocked, id_blocks, block_size = _blocked_ids(ix, mode_num)
    r = ix.r
    nfield = (ix.n_arr.astype(np.uint32) & 0x3FF) | \
             (((blocked >> 16) & 0x3F).astype(np.uint32) << 10)
    ofield = (ix.offset_arr.astype(np.uint32) & 0x3FF) | \
             (ix.c_arr.astype(np.uint32) << 10)
    if mode_num == 2:
        ofield |= ((blocked >> 22) & 0x3).astype(np.uint32) << 14
    else:  # blocked-thresholds
        bits = _thr_bits(ix)
        ofield |= bits[:, 0].astype(np.uint32) << 13
        ofield |= bits[:, 1].astype(np.uint32) << 14
        ofield |= bits[:, 2].astype(np.uint32) << 15
    rows = np.zeros(r, dtype=[("id", "<u2"), ("n", "<u2"), ("off", "<u2")])
    rows["id"] = (blocked & 0xFFFF).astype(np.uint16)
    rows["n"] = nfield.astype(np.uint16)
    rows["off"] = ofield.astype(np.uint16)
    return rows.tobytes(), id_blocks, block_size


def _rows_tally(ix: MoveIndex, with_thr: bool) -> bytes:
    """Sampled 3B rows: n u8 | offset u8 | c u8."""
    _check_run_fields(ix, 0x1FF if with_thr else 0x3FF)
    r = ix.r
    n = ix.n_arr.astype(np.uint32)
    off = ix.offset_arr.astype(np.uint32)
    nfield = (n & 0xFF).astype(np.uint8)
    ofield = (off & 0xFF).astype(np.uint8)
    if with_thr:  # mode 7: 1 bit each for n/off high, c at bits 2-4
        cfield = (((off >> 8) & 1) | (((n >> 8) & 1) << 1) |
                  (ix.c_arr.astype(np.uint32) << 2)).astype(np.uint32)
        bits = _thr_bits(ix)
        cfield |= bits[:, 0].astype(np.uint32) << 5
        cfield |= bits[:, 1].astype(np.uint32) << 6
        cfield |= bits[:, 2].astype(np.uint32) << 7
    else:        # mode 5: 2 bits each, c at bits 4-7
        cfield = (((off >> 8) & 3) | (((n >> 8) & 3) << 2) |
                  (ix.c_arr.astype(np.uint32) << 4))
    rows = np.zeros(r, dtype=[("n", "u1"), ("off", "u1"), ("c", "u1")])
    rows["n"] = nfield
    rows["off"] = ofield
    rows["c"] = cfield.astype(np.uint8)
    return rows.tobytes()


def _tally_table(ix: MoveIndex, ckpt: int = TALLY_CHECKPOINTS) -> bytes:
    """build_move_rows tally logic (move_structure_build.cpp:486-497,
    571-594, 677-682): per char, per checkpoint, the LF-destination run
    (pp_id) of the latest run of that char at-or-before the checkpoint;
    earlier checkpoints backfilled with the first run's pp_id.  `ckpt`
    mirrors --checkpoint (movi_parser.cpp:104, default 20)."""
    r, sigma = ix.r, ix.sigma
    nlen = r // ckpt + 2
    out = bytearray()
    out += struct.pack("<I", ckpt)
    out += struct.pack("<Q", nlen)
    idxs = np.arange(r)
    c_eff = ix.c_arr.astype(np.int64)
    c_eff_valid = idxs != ix.end_bwt_idx
    vals = np.zeros((sigma, nlen), dtype=np.int64)
    for a in range(sigma):
        isa = (c_eff == a) & c_eff_valid
        rows_a = np.flatnonzero(isa)
        if len(rows_a) == 0:
            vals[a, :] = r
            continue
        pp = ix.id_arr[rows_a]
        # checkpoints 0..nlen-2 at rows k*ckpt; last entry = final value
        for k in range(nlen - 1):
            row = k * ckpt
            j = np.searchsorted(rows_a, row, side="right") - 1
            vals[a, k] = pp[j] if j >= 0 else pp[0]
        vals[a, nlen - 1] = pp[-1]
    # MoveTally: u32 right + u8 left (5 bytes, packed)
    for a in range(sigma):
        arr = np.zeros(nlen, dtype=[("right", "<u4"), ("left", "u1")])
        arr["right"] = vals[a] & 0xFFFFFFFF
        arr["left"] = (vals[a] >> 32) & 0xFF
        out += arr.tobytes()
    return bytes(out)


def _sep_thresholds_bytes(ix: MoveIndex) -> bytes:
    """ThresholdsRow = uint16_t values[4] (move_structure.hpp:41-43);
    entries in vector-index order, then the row->index map."""
    out = bytearray()
    items = (sorted(ix.sep_row_map.items(), key=lambda kv: kv[1])
             if ix.sep_row_map else [])
    out += struct.pack("<Q", len(items))
    for row, k in items:
        vals = ix.sep_thresholds[k]
        out += struct.pack("<HHHH", *(int(v) & 0xFFFF for v in vals))
    out += struct.pack("<Q", len(items))
    for row, k in items:
        out += struct.pack("<QQ", row, k)
    return bytes(out)


def write_movi(ix: MoveIndex, path: str,
               tally_checkpoints: int = TALLY_CHECKPOINTS,
               header: str = "modern", split_table: bool = False):
    """header: "modern" (MoviHeader, default), "legacy" (single mode
    byte + length/r/end_bwt_idx), or "none" (raw characteristics only)
    -- write_index_header, move_structure_io.cpp:42-63.

    split_table: also write the packed main row table to `rlbwt.movi`
    next to `path`, the file the reference's `--mmap` query path
    memory-maps (read_main_table, move_structure_io.cpp:361-384;
    index.movi keeps the table region too -- the mmap reader seeks past
    it)."""
    mode_num, _, use_thr, split_thr = MODE_INFO[ix.mode]
    with open(path, "wb") as f:
        if header == "modern":
            f.write(_header_bytes(mode_num, ix))
        else:
            if header == "legacy":
                f.write(struct.pack("<b", mode_num))
            f.write(struct.pack("<QQQ", ix.length, ix.r, ix.end_bwt_idx))
        f.write(_basic_bytes(ix, nt_splitting=1 if mode_num in (1, 4) else 0,
                             constant=1 if mode_num == 1 else 0))
        thr_overflow = None
        if mode_num in (0, 1, 4):
            rows, thr_overflow = _rows_movi1(ix, constant=(mode_num == 1))
            f.write(rows)
        elif mode_num in (3, 6):
            rows = _rows_regular(ix, with_thr=(mode_num == 6))
            f.write(rows)
        elif mode_num in (2, 8):
            rows, id_blocks, block_size = _rows_blocked(ix, mode_num)
            f.write(rows)
        elif mode_num in (5, 7):
            rows = _rows_tally(ix, with_thr=(mode_num == 7))
            f.write(rows)
            f.write(_tally_table(ix, tally_checkpoints))
        else:
            raise ValueError(f"unsupported mode {ix.mode}")
        if split_table:
            with open(os.path.join(os.path.dirname(os.path.abspath(path)),
                                   "rlbwt.movi"), "wb") as rf:
                rf.write(rows)
        f.write(_overflow_bytes(thr_overflow=thr_overflow))
        f.write(_counts_bytes(ix))
        if mode_num in (2, 8):
            f.write(struct.pack("<Q", id_blocks.shape[1]))
            for a in range(ix.sigma):
                f.write(id_blocks[a].astype("<u4").tobytes())
            f.write(struct.pack("<Q", block_size))
        if use_thr and ix.separators:
            f.write(_sep_thresholds_bytes(ix))


def write_movi_colored(ix: MoveIndex, doc_set_inds: np.ndarray, path: str,
                       compressed: bool = False):
    """index_colored.movi: regular(-thresholds) rows with an embedded
    color_id u32 (MoveRowColored, add_colors_to_rlbwt
    move_structure_color.cpp:352-374).  Row = id u32 | color_id u32 |
    n u16 | offset u16 (12 B)."""
    mode_num, _, _, _ = MODE_INFO[ix.mode]
    assert mode_num in (3, 6), "colored rows exist for regular modes only"
    color = doc_set_inds.astype(np.int64)
    if compressed:
        color = np.where(color >= (1 << 16), 0xFFFF, color)
    base = _rows_regular(ix, with_thr=(mode_num == 6))
    rows8 = np.frombuffer(base, dtype=[("id", "<u4"), ("n", "<u2"),
                                       ("off", "<u2")])
    rows = np.zeros(ix.r, dtype=[("id", "<u4"), ("color", "<u4"),
                                 ("n", "<u2"), ("off", "<u2")])
    rows["id"] = rows8["id"]
    rows["color"] = (color & 0xFFFFFFFF).astype(np.uint32)
    rows["n"] = rows8["n"]
    rows["off"] = rows8["off"]
    with open(path, "wb") as f:
        f.write(_header_bytes(mode_num, ix))
        f.write(_basic_bytes(ix))
        f.write(rows.tobytes())
        f.write(_overflow_bytes())
        f.write(_counts_bytes(ix))


# ---------------------------------------------------------------------------
def read_movi_header(path: str, mode_hint: int = -1):
    """Read the header of a reference index.movi file.  Detects the
    modern MoviHeader by magic; otherwise falls back to the legacy
    single-byte-mode layout, or the headerless layout when `mode_hint`
    is given (read_index_header, move_structure_io.cpp:66-109)."""
    with open(path, "rb") as f:
        hdr = f.read(48)
    magic = struct.unpack("<I", hdr[:4])[0]
    if magic == MOVI_MAGIC:
        _, major, minor, patch, mode_num = struct.unpack(
            "<IBBBBxxxxxxxx", hdr[:16])
        length, r, original_r, end_bwt_idx = struct.unpack(
            "<QQQQ", hdr[16:48])
        return dict(mode_num=mode_num, version=(major, minor, patch),
                    length=length, r=r, original_r=original_r,
                    end_bwt_idx=end_bwt_idx, header_size=48)
    mode_b = hdr[0]
    if mode_hint < 0 and 0 <= mode_b <= 8:
        length, r, end_bwt_idx = struct.unpack("<QQQ", hdr[1:25])
        if end_bwt_idx < length and r <= length:
            return dict(mode_num=int(mode_b), version=(1, 0, 0),
                        length=length, r=r, original_r=0,
                        end_bwt_idx=end_bwt_idx, header_size=25)
    assert mode_hint >= 0, "not a Movi index (pass mode_hint for "         "headerless legacy files)"
    length, r, end_bwt_idx = struct.unpack("<QQQ", hdr[:24])
    return dict(mode_num=mode_hint, version=(1, 0, 0), length=length,
                r=r, original_r=0, end_bwt_idx=end_bwt_idx,
                header_size=24)


def _reconstruct_ids(n_arr: np.ndarray, c_arr: np.ndarray,
                     end_bwt_idx: int):
    """Full LF-destination runs from (n, c) alone.

    Blocked rows store ids as 24-bit deltas from per-block checkpoints
    and tally rows store no id at all (move_row_configs.hpp:54-136); on
    the device layout the ids are always materialized as full arrays, so instead of
    porting the checkpoint walks we recompute LF directly: the head of
    the k-th run of character a maps to position
    1 + (total of chars < a) + (rows of a in earlier a-runs), and the
    '$' run maps to row 0.  Returns (id_arr, offset_arr)."""
    r = len(n_arr)
    n64 = n_arr.astype(np.int64)
    all_p = np.concatenate([[0], np.cumsum(n64)])
    sigma = int(c_arr.max()) + 1
    mask = np.arange(r) != end_bwt_idx
    lf_abs = np.zeros(r, dtype=np.int64)
    totals = np.zeros(sigma, dtype=np.int64)
    for a in range(sigma):
        rows_a = np.flatnonzero(mask & (c_arr == a))
        totals[a] = n64[rows_a].sum()
    base = 1 + np.concatenate([[0], np.cumsum(totals)[:-1]])
    for a in range(sigma):
        rows_a = np.flatnonzero(mask & (c_arr == a))
        cum = np.concatenate([[0], np.cumsum(n64[rows_a])[:-1]])
        lf_abs[rows_a] = base[a] + cum
    lf_abs[end_bwt_idx] = 0
    id_arr = np.searchsorted(all_p[1:-1], lf_abs, side="right")
    offset_arr = (lf_abs - all_p[id_arr]).astype(np.int32)
    return id_arr.astype(np.int64), offset_arr


def read_movi(path: str, mode_hint: int = -1,
              mmap_table: bool = False) -> MoveIndex:
    """Deserialize a reference index.movi into a MoveIndex (SoA): all 9
    packed layouts, with modern/legacy/headerless headers.  Used for
    interop with reference-built indexes.

    mmap_table: memory-map the packed row table from the sibling
    `rlbwt.movi` (the reference's `--mmap` pair layout, read_main_table
    move_structure_io.cpp:361-384) instead of copying it through the
    stream; the table region inside index.movi is seeked past.  Field
    decoding then streams the mapped pages without a second copy."""
    hdr = read_movi_header(path, mode_hint)

    def rows_region(f, r: int, dtype) -> np.ndarray:
        nbytes = r * np.dtype(dtype).itemsize
        if mmap_table:
            rl = os.path.join(os.path.dirname(os.path.abspath(path)),
                              "rlbwt.movi")
            mm = np.memmap(rl, dtype=dtype, mode="r", shape=(r,))
            f.seek(nbytes, 1)
            return mm
        return np.frombuffer(f.read(nbytes), dtype=dtype)
    mode_num = hdr["mode_num"]
    mode = {0: "large", 1: "constant", 2: "blocked", 3: "regular",
            4: "split", 5: "sampled", 6: "regular-thresholds",
            7: "sampled-thresholds", 8: "blocked-thresholds"}[mode_num]
    use_thr = mode_num in (0, 6, 7, 8)
    with open(path, "rb") as f:
        f.seek(hdr["header_size"])
        end_thr = np.frombuffer(f.read(32), dtype="<u8")
        f.read(64)  # end next down/up
        (ams,) = struct.unpack("<Q", f.read(8))
        alphamap = np.frombuffer(f.read(ams * 8), dtype="<u8").astype(np.int64)
        (als,) = struct.unpack("<Q", f.read(8))
        alphabet = np.frombuffer(f.read(als), dtype=np.uint8)
        f.read(3)  # nt_splitting + constant
        r = hdr["r"]
        if mode_num in (3, 6):
            rows = rows_region(
                f, r, [("id", "<u4"), ("n", "<u2"), ("off", "<u2")])
            len_bits = 11 if mode_num == 6 else 12
            mask = (1 << len_bits) - 1
            n_arr = (rows["n"] & mask).astype(np.int32)
            offset_arr = (rows["off"] & mask).astype(np.int32)
            id_arr = rows["id"].astype(np.int64) | \
                (((rows["off"].astype(np.int64) >> 12) & 0xF) << 32)
            c_arr = ((rows["n"] >> 13) & 0x7).astype(np.uint8)
            thr = None
            if mode_num == 6:
                b0 = ((rows["off"] >> 11) & 1).astype(np.int64)
                b1 = ((rows["n"] >> 11) & 1).astype(np.int64)
                b2 = ((rows["n"] >> 12) & 1).astype(np.int64)
                n64 = n_arr.astype(np.int64)
                thr = np.stack([b0 * n64, b1 * n64, b2 * n64],
                               axis=1).astype(np.int32)
        elif mode_num in (0, 1, 4):
            # large/split 12 B rows; constant appends 3+3 u16 next
            # pointers (rebuilt on demand from the SoA layout)
            if mode_num == 1:
                rows = rows_region(
                    f, r, [("id", "<u4"), ("n", "<u2"), ("off", "<u2"),
                           ("thr", "<u2"), ("ovf", "u1"), ("ts", "u1"),
                           ("nup", "<u2", (3,)), ("ndown", "<u2", (3,))])
            else:
                rows = rows_region(
                    f, r, [("id", "<u4"), ("n", "<u2"), ("off", "<u2"),
                           ("thr", "<u2"), ("ovf", "u1"), ("ts", "u1")])
            n_arr = rows["n"].astype(np.int32)
            offset_arr = rows["off"].astype(np.int32)
            id_arr = rows["id"].astype(np.int64) | \
                ((rows["ovf"].astype(np.int64) & 0xF) << 32)
            c_arr = ((rows["ts"] >> 6) & 0x3).astype(np.uint8)
            thr = None          # resolved after the overflow tables
            rows_movi1 = rows
        elif mode_num in (2, 8):
            # blocked 6 B rows (move_row_configs.hpp:54-104); the 24-bit
            # id deltas are ignored -- ids are recomputed in full
            rows = rows_region(
                f, r, [("id", "<u2"), ("n", "<u2"), ("off", "<u2")])
            n_arr = (rows["n"] & 0x3FF).astype(np.int32)
            offset_arr = (rows["off"] & 0x3FF).astype(np.int32)
            c_arr = ((rows["off"] >> 10) & 0x7).astype(np.uint8)
            thr = None
            if mode_num == 8:
                n64 = n_arr.astype(np.int64)
                thr = np.stack(
                    [((rows["off"] >> (13 + s)) & 1).astype(np.int64) * n64
                     for s in range(3)], axis=1).astype(np.int32)
            id_arr, off2 = _reconstruct_ids(n_arr, c_arr,
                                            hdr["end_bwt_idx"])
            assert np.array_equal(off2, offset_arr), \
                "blocked offset mismatch during id reconstruction"
        elif mode_num in (5, 7):
            # tally 3 B rows (move_row_configs.hpp:107-136); no id stored
            rows = rows_region(f, r, [("n", "u1"), ("off", "u1"),
                                      ("c", "u1")])
            cf = rows["c"].astype(np.int32)
            if mode_num == 7:
                n_arr = rows["n"].astype(np.int32) | (((cf >> 1) & 1) << 8)
                offset_arr = rows["off"].astype(np.int32) | ((cf & 1) << 8)
                c_arr = ((cf >> 2) & 0x7).astype(np.uint8)
                n64 = n_arr.astype(np.int64)
                thr = np.stack(
                    [((cf >> (5 + s)) & 1).astype(np.int64) * n64
                     for s in range(3)], axis=1).astype(np.int32)
            else:
                n_arr = rows["n"].astype(np.int32) | (((cf >> 2) & 3) << 8)
                offset_arr = rows["off"].astype(np.int32) | ((cf & 3) << 8)
                c_arr = ((cf >> 4) & 0x7).astype(np.uint8)
                thr = None
            # skip the tally checkpoint table (rebuilt on write)
            (ckpt,) = struct.unpack("<I", f.read(4))
            (nlen,) = struct.unpack("<Q", f.read(8))
            sigma_f = len(alphabet)
            f.read(sigma_f * nlen * 5)
            id_arr, off2 = _reconstruct_ids(n_arr, c_arr,
                                            hdr["end_bwt_idx"])
            assert np.array_equal(off2, offset_arr), \
                "tally offset mismatch during id reconstruction"
        else:
            raise NotImplementedError(
                f"read_movi for mode {mode} not supported yet")
        n_ovf_t, off_ovf_t, thr_ovf_t = _read_overflow_tables(
            f, max(1, len(alphabet) - 1))
        if mode_num in (0, 1, 4):
            # resolve overflow escapes (get_n/get_offset/get_thresholds,
            # move_structure.cpp:311-335): a CLEARED overflow bit means
            # the packed field holds a table index, not the value
            ovfb = rows_movi1["ovf"]
            for bit, table, arr in ((4, n_ovf_t, n_arr),
                                    (5, off_ovf_t, offset_arr)):
                ri = np.flatnonzero(((ovfb >> bit) & 1) == 0)
                if len(ri):
                    vals = table[arr[ri]]
                    assert int(vals.max()) <= np.iinfo(np.int32).max
                    arr[ri] = vals.astype(np.int32)
            n64 = n_arr.astype(np.int64)
            thr = np.zeros((r, 3), dtype=np.int32)
            for slot in range(3):
                status = (rows_movi1["ts"] >> (slot * 2)) & 0x3
                thr[:, slot] = np.where(
                    status == 0, 0,
                    np.where(status == 3, n_arr,
                             rows_movi1["thr"].astype(np.int32)))
            ri = np.flatnonzero(((ovfb >> 6) & 1) == 0)
            if len(ri):
                st0 = rows_movi1["ts"][ri] & 3
                tab_idx = np.where(
                    st0 == 0, 0,
                    np.where(st0 == 3, n64[ri],
                             rows_movi1["thr"][ri].astype(np.int64)))
                tab = thr_ovf_t
                if tab.shape[1] < 3:  # (sigma-1)-wide entries, sigma < 4
                    tab = np.pad(tab, ((0, 0), (0, 3 - tab.shape[1])))
                thr[ri] = tab[tab_idx][:, :3].astype(np.int32)
        (cs,) = struct.unpack("<Q", f.read(8))
        counts = np.frombuffer(f.read(cs * 8), dtype="<u8").astype(np.int64)
        (ls,) = struct.unpack("<Q", f.read(8))
        last_runs = np.frombuffer(f.read(ls * 8), dtype="<u8").astype(np.int64)
        last_offsets = np.frombuffer(f.read(ls * 8), dtype="<u8").astype(np.int64)
        first_runs = np.frombuffer(f.read(ls * 8), dtype="<u8").astype(np.int64)
        first_offsets = np.frombuffer(f.read(ls * 8), dtype="<u8").astype(np.int64)

    all_p = np.concatenate([[0], np.cumsum(n_arr.astype(np.int64))])
    return MoveIndex(
        mode=mode, length=hdr["length"], r=r,
        original_r=hdr["original_r"], end_bwt_idx=hdr["end_bwt_idx"],
        alphabet=alphabet, alphamap=alphamap, counts=counts,
        n_arr=n_arr, offset_arr=offset_arr, id_arr=id_arr, c_arr=c_arr,
        all_p=all_p, thr=thr,
        end_bwt_idx_thresholds=end_thr.astype(np.int64),
        first_runs=first_runs, first_offsets=first_offsets,
        last_runs=last_runs, last_offsets=last_offsets,
    )


# ---------------------------------------------------------------------------
# Auxiliary reference-format artifacts


def write_ssa(ix: MoveIndex, path: str):
    """ssa.movi: sample rate, sampled SA entries, and all_p (one u64 per
    run) -- serialize_sampled_SA (move_structure_io.cpp:710-723)."""
    assert ix.sampled_SA is not None, "index has no sampled SA"
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", ix.sa_sample_rate))
        f.write(struct.pack("<Q", len(ix.sampled_SA)))
        f.write(ix.sampled_SA.astype("<u8").tobytes())
        all_p = ix.all_p[:-1].astype("<u8")
        f.write(struct.pack("<Q", len(all_p)))
        f.write(all_p.tobytes())


def read_ssa(path: str):
    """Returns (sample_rate, sampled_SA) from a reference ssa.movi
    (deserialize_sampled_SA, move_structure_io.cpp:725-744)."""
    with open(path, "rb") as f:
        (rate,) = struct.unpack("<Q", f.read(8))
        (n,) = struct.unpack("<Q", f.read(8))
        sampled = np.frombuffer(f.read(n * 8), dtype="<u8").astype(np.int64)
    return int(rate), sampled


def write_ftab_bin(ftab: np.ndarray, k: int, path: str):
    """ftab.<k>.bin: k, 4^k, MoveInterval[4^k] (4 u64 each) --
    write_ftab (move_structure_io.cpp:771-785)."""
    size = 4 ** k
    assert ftab.shape == (size, 4), f"ftab shape {ftab.shape} != ({size}, 4)"
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", k, size))
        f.write(ftab.astype("<u8").tobytes())


def read_ftab_bin(path: str):
    """Returns (k, ftab int64[4^k, 4]) from a reference ftab.<k>.bin
    (read_ftab, move_structure_io.cpp:787-832)."""
    with open(path, "rb") as f:
        k, size = struct.unpack("<QQ", f.read(16))
        ftab = np.frombuffer(f.read(size * 32),
                             dtype="<u8").astype(np.int64).reshape(size, 4)
    return int(k), ftab


# ---------------------------------------------------------------------------
# Movi Color binary artifacts (move_structure_io.cpp:513-641)


def write_doc_pats_bin(doc_pats: np.ndarray, path: str):
    """doc_pats.bin: raw u16 per BWT row, no header
    (serialize_doc_pats, move_structure_io.cpp:550-556)."""
    doc_pats.astype("<u2").tofile(path)


def read_doc_pats_bin(path: str, length: int) -> np.ndarray:
    """deserialize_doc_pats (move_structure_io.cpp:558-568)."""
    dp = np.fromfile(path, dtype="<u2", count=length)
    if len(dp) != length:
        raise ValueError(f"{path}: expected {length} doc_pats, got {len(dp)}")
    return dp.astype(np.uint16)


def write_doc_sets_bin(unique_doc_sets, doc_set_inds: np.ndarray, path: str):
    """doc_sets.bin / compress_doc_sets.bin: u64 count, then per set
    {u16 size, u16 docs[size]}, then u32 doc_set_inds[r]
    (serialize_doc_sets, move_structure_io.cpp:571-585)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(unique_doc_sets)))
        for s in unique_doc_sets:
            f.write(struct.pack("<H", len(s)))
            f.write(np.asarray(s, dtype="<u2").tobytes())
        f.write(np.asarray(doc_set_inds, dtype="<u4").tobytes())


def read_doc_sets_bin(path: str, r: int, with_inds: bool = True):
    """deserialize_doc_sets (move_structure_io.cpp:612-634).  Returns
    (unique_doc_sets, doc_set_inds or None) -- colored-row indexes store
    the per-run indices inside the rows instead (COLOR_MODE == 1), so
    the trailing r u32s are absent; pass with_inds=False then."""
    with open(path, "rb") as f:
        (cnt,) = struct.unpack("<Q", f.read(8))
        sets = []
        for _ in range(cnt):
            (k,) = struct.unpack("<H", f.read(2))
            sets.append(np.frombuffer(f.read(k * 2),
                                      dtype="<u2").astype(np.uint16))
        inds = None
        if with_inds:
            inds = np.frombuffer(f.read(r * 4),
                                 dtype="<u4").astype(np.int64)
            if len(inds) != r:
                raise ValueError(f"{path}: expected {r} doc_set_inds")
    return sets, inds


def write_doc_sets_flat_bin(unique_doc_sets, doc_set_inds: np.ndarray,
                            path: str):
    """doc_sets_flat.bin: u64 flat size, u16 flat [len, docs...] blocks,
    then 5-byte (u32 low | u8 high) per-run element offsets
    (flat_and_serialize_colors_vectors, move_structure_io.cpp:513-548)."""
    parts = []
    offsets = np.zeros(max(len(unique_doc_sets), 1), dtype=np.int64)
    off = 0
    for i, s in enumerate(unique_doc_sets):
        offsets[i] = off
        parts.append(np.concatenate([[len(s)], s]).astype("<u2"))
        off += len(s) + 1
    flat = (np.concatenate(parts).astype("<u2") if parts
            else np.zeros(0, dtype="<u2"))
    flat_inds = offsets[np.asarray(doc_set_inds, dtype=np.int64)]
    packed = np.zeros(len(flat_inds), dtype=[("right", "<u4"), ("left", "u1")])
    packed["right"] = flat_inds & 0xFFFFFFFF
    packed["left"] = (flat_inds >> 32) & 0xFF
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(flat)))
        f.write(flat.tobytes())
        f.write(packed.tobytes())


def read_doc_sets_flat_bin(path: str, r: int):
    """deserialize_doc_sets_flat (move_structure_io.cpp:589-609).
    Returns (unique_doc_sets, doc_set_inds) reconstructed from the flat
    layout (sets ordered by flat offset)."""
    with open(path, "rb") as f:
        (fs,) = struct.unpack("<Q", f.read(8))
        flat = np.frombuffer(f.read(fs * 2), dtype="<u2").astype(np.int64)
        packed = np.frombuffer(f.read(r * 5),
                               dtype=[("right", "<u4"), ("left", "u1")])
        if len(packed) != r:
            raise ValueError(f"{path}: expected {r} doc_set_flat_inds")
    flat_inds = (packed["right"].astype(np.int64)
                 | (packed["left"].astype(np.int64) << 32))
    sets = []
    off_to_idx = {}
    off = 0
    while off < len(flat):
        off_to_idx[off] = len(sets)
        k = int(flat[off])
        sets.append(flat[off + 1: off + 1 + k].astype(np.uint16))
        off += k + 1
    inds = np.array([off_to_idx[int(o)] for o in flat_inds], dtype=np.int64)
    return sets, inds


def read_movi_colored(path: str):
    """Deserialize an index_colored.movi (MoveRowColored 12 B rows,
    move_row_colored.hpp; written by color-move-rows).  Returns
    (MoveIndex, color_ids int64[r])."""
    hdr = read_movi_header(path)
    mode_num = hdr["mode_num"]
    assert mode_num in (3, 6), "colored rows exist for regular modes only"
    mode = {3: "regular", 6: "regular-thresholds"}[mode_num]
    with open(path, "rb") as f:
        f.seek(hdr["header_size"])
        end_thr = np.frombuffer(f.read(32), dtype="<u8")
        f.read(64)
        (ams,) = struct.unpack("<Q", f.read(8))
        alphamap = np.frombuffer(f.read(ams * 8), dtype="<u8").astype(np.int64)
        (als,) = struct.unpack("<Q", f.read(8))
        alphabet = np.frombuffer(f.read(als), dtype=np.uint8)
        f.read(3)
        r = hdr["r"]
        rows = np.frombuffer(
            f.read(r * 12),
            dtype=[("id", "<u4"), ("color", "<u4"), ("n", "<u2"),
                   ("off", "<u2")])
        len_bits = 11 if mode_num == 6 else 12
        mask = (1 << len_bits) - 1
        n_arr = (rows["n"] & mask).astype(np.int32)
        offset_arr = (rows["off"] & mask).astype(np.int32)
        id_arr = rows["id"].astype(np.int64) | \
            (((rows["off"].astype(np.int64) >> 12) & 0xF) << 32)
        c_arr = ((rows["n"] >> 13) & 0x7).astype(np.uint8)
        thr = None
        if mode_num == 6:
            n64 = n_arr.astype(np.int64)
            b0 = ((rows["off"] >> 11) & 1).astype(np.int64)
            b1 = ((rows["n"] >> 11) & 1).astype(np.int64)
            b2 = ((rows["n"] >> 12) & 1).astype(np.int64)
            thr = np.stack([b0 * n64, b1 * n64, b2 * n64],
                           axis=1).astype(np.int32)
        color = rows["color"].astype(np.int64)
        _read_overflow_tables(f, max(1, len(alphabet) - 1))  # always empty
        (cs,) = struct.unpack("<Q", f.read(8))
        counts = np.frombuffer(f.read(cs * 8), dtype="<u8").astype(np.int64)
        (ls,) = struct.unpack("<Q", f.read(8))
        last_runs = np.frombuffer(f.read(ls * 8), dtype="<u8").astype(np.int64)
        last_offsets = np.frombuffer(f.read(ls * 8), dtype="<u8").astype(np.int64)
        first_runs = np.frombuffer(f.read(ls * 8), dtype="<u8").astype(np.int64)
        first_offsets = np.frombuffer(f.read(ls * 8), dtype="<u8").astype(np.int64)

    all_p = np.concatenate([[0], np.cumsum(n_arr.astype(np.int64))])
    ix = MoveIndex(
        mode=mode, length=hdr["length"], r=r,
        original_r=hdr["original_r"], end_bwt_idx=hdr["end_bwt_idx"],
        alphabet=alphabet, alphamap=alphamap, counts=counts,
        n_arr=n_arr, offset_arr=offset_arr, id_arr=id_arr, c_arr=c_arr,
        all_p=all_p, thr=thr,
        end_bwt_idx_thresholds=end_thr.astype(np.int64),
        first_runs=first_runs, first_offsets=first_offsets,
        last_runs=last_runs, last_offsets=last_offsets,
    )
    return ix, color
