"""Reference index.movi serialization: exact byte-size parity with
tests/test_build.cpp golden sizes, and read/write round trip."""

import os

import numpy as np
import pytest

from conftest import REF_DATA, requires_ref_data

from movi_tpu.cpu_ref.scalar import ScalarEngine
from movi_tpu.index.movi_format import read_movi, read_movi_header, write_movi
from movi_tpu.index.structure import build_move_index

GOLDEN_SIZES = {
    "regular": 871479,
    "regular-thresholds": 948119,
    "sampled": 437006,
    "sampled-thresholds": 475326,
    "blocked": 654253,
    "blocked-thresholds": 711733,
    "large": 1305995,
}

GOLDEN_SIZES_SEP = {
    "regular": 871496,
    "regular-thresholds": 948232,
    "sampled": 464203,
    "sampled-thresholds": 505009,
    "blocked": 654280,
    "blocked-thresholds": 711854,
}


@requires_ref_data
@pytest.mark.parametrize("mode", sorted(GOLDEN_SIZES))
def test_movi_file_size_matches_reference(bwt_runs, tmp_path, mode):
    ix = build_move_index(bwt_runs, mode)
    p = str(tmp_path / "index.movi")
    write_movi(ix, p)
    assert os.path.getsize(p) == GOLDEN_SIZES[mode], mode


@requires_ref_data
@pytest.mark.parametrize("mode", sorted(GOLDEN_SIZES_SEP))
def test_movi_file_size_with_separators(tmp_path, mode):
    from movi_tpu.build.prepare_ref import prepare_ref
    from movi_tpu.build.suffix import build_bwt_runs

    ref = prepare_ref(os.path.join(REF_DATA, "ref.fasta"), separators=True)
    runs = build_bwt_runs(ref.text)
    ix = build_move_index(runs, mode, separators=True)
    p = str(tmp_path / "index.movi")
    write_movi(ix, p)
    assert os.path.getsize(p) == GOLDEN_SIZES_SEP[mode], mode


@requires_ref_data
def test_movi_roundtrip_regular_thresholds(bwt_runs, sample_reads, tmp_path):
    ix = build_move_index(bwt_runs, "regular-thresholds")
    p = str(tmp_path / "index.movi")
    write_movi(ix, p)
    hdr = read_movi_header(p)
    assert hdr["mode_num"] == 6
    assert hdr["r"] == ix.r
    ix2 = read_movi(p)
    np.testing.assert_array_equal(ix2.n_arr, ix.n_arr)
    np.testing.assert_array_equal(ix2.offset_arr, ix.offset_arr)
    np.testing.assert_array_equal(ix2.id_arr, ix.id_arr)
    np.testing.assert_array_equal(ix2.c_arr, ix.c_arr)
    np.testing.assert_array_equal(ix2.thr, ix.thr)
    # PML equality through the round-tripped index
    e1, e2 = ScalarEngine(ix), ScalarEngine(ix2)
    for name, seq in sample_reads[:5]:
        assert e1.query_pml(seq) == e2.query_pml(seq), name


@requires_ref_data
def test_movi_roundtrip_large(bwt_runs, sample_reads, tmp_path):
    ix = build_move_index(bwt_runs, "large")
    p = str(tmp_path / "index.movi")
    write_movi(ix, p)
    ix2 = read_movi(p)
    np.testing.assert_array_equal(ix2.thr, ix.thr)
    e1, e2 = ScalarEngine(ix), ScalarEngine(ix2)
    for name, seq in sample_reads[:3]:
        assert e1.query_pml(seq) == e2.query_pml(seq), name


@pytest.mark.parametrize("mode", ["blocked", "blocked-thresholds",
                                  "sampled", "sampled-thresholds",
                                  "constant", "split"])
def test_movi_roundtrip_blocked_tally(bwt_runs, tmp_path, mode):
    """Blocked/tally index.movi files read back with ids reconstructed in
    full from (n, c) -- the device layout never uses delta/checkpoint ids."""
    import numpy as np

    from movi_tpu.index.movi_format import read_movi, write_movi
    from movi_tpu.index.structure import build_move_index

    ix = build_move_index(bwt_runs, mode)
    p = str(tmp_path / "index.movi")
    write_movi(ix, p)
    ix2 = read_movi(p)
    assert np.array_equal(ix2.n_arr, ix.n_arr)
    assert np.array_equal(ix2.offset_arr, ix.offset_arr)
    assert np.array_equal(ix2.id_arr, ix.id_arr)
    assert np.array_equal(ix2.c_arr, ix.c_arr)
    if ix.thr is not None:
        assert np.array_equal(ix2.thr, ix.thr)


def test_movi_legacy_and_headerless(bwt_runs, tmp_path):
    """--legacy-header (single mode byte) and --no-header layouts
    (write_index_header, move_structure_io.cpp:42-63) roundtrip."""
    import numpy as np

    from movi_tpu.index.movi_format import read_movi, write_movi
    from movi_tpu.index.structure import build_move_index

    ix = build_move_index(bwt_runs, "regular-thresholds")
    p1 = str(tmp_path / "legacy.movi")
    write_movi(ix, p1, header="legacy")
    ix1 = read_movi(p1)
    assert np.array_equal(ix1.n_arr, ix.n_arr)
    assert np.array_equal(ix1.id_arr, ix.id_arr)

    p2 = str(tmp_path / "nohdr.movi")
    write_movi(ix, p2, header="none")
    ix2 = read_movi(p2, mode_hint=6)
    assert np.array_equal(ix2.n_arr, ix.n_arr)
    assert np.array_equal(ix2.thr, ix.thr)


def test_ssa_and_ftab_reference_formats(bwt_runs, tmp_path):
    """ssa.movi (move_structure_io.cpp:710-744) and ftab.<k>.bin
    (:771-832) reference binaries roundtrip."""
    import numpy as np

    from movi_tpu.cpu_ref.advanced import AdvancedEngine
    from movi_tpu.index.movi_format import (read_ftab_bin, read_ssa,
                                            write_ftab_bin, write_ssa)
    from movi_tpu.index.structure import build_move_index

    ix = build_move_index(bwt_runs, "regular-thresholds")
    ix.sampled_SA = bwt_runs.sampled_sa(100)
    ix.sa_sample_rate = 100
    p = str(tmp_path / "ssa.movi")
    write_ssa(ix, p)
    rate, sampled = read_ssa(p)
    assert rate == 100 and np.array_equal(sampled, ix.sampled_SA)
    # header + entries + all_p, all u64
    want_size = 8 + 8 + len(ix.sampled_SA) * 8 + 8 + ix.r * 8
    assert os.path.getsize(p) == want_size

    eng = AdvancedEngine(ix, ftab_k=5)
    p2 = str(tmp_path / "ftab.5.bin")
    write_ftab_bin(eng.ftab, 5, p2)
    k, ftab = read_ftab_bin(p2)
    assert k == 5 and np.array_equal(ftab, eng.ftab)
    assert os.path.getsize(p2) == 16 + (4 ** 5) * 32


def test_movi_colored_roundtrip(bwt_runs, tmp_path):
    """write_movi_colored -> read_movi_colored (MoveRowColored 12 B,
    move_row_colored.hpp)."""
    import numpy as np

    from movi_tpu.index.movi_format import (read_movi_colored,
                                            write_movi_colored)
    from movi_tpu.index.structure import build_move_index

    ix = build_move_index(bwt_runs, "regular-thresholds")
    rng = np.random.default_rng(0)
    colors = rng.integers(0, 500, size=ix.r).astype(np.int64)
    p = str(tmp_path / "index_colored.movi")
    write_movi_colored(ix, colors, p)
    ix2, col2 = read_movi_colored(p)
    assert np.array_equal(col2, colors)
    assert np.array_equal(ix2.n_arr, ix.n_arr)
    assert np.array_equal(ix2.id_arr, ix.id_arr)
    assert np.array_equal(ix2.thr, ix.thr)


@requires_ref_data
def test_threshold_overflow_roundtrip(bwt_runs, tmp_path):
    """Rows with >= 2 distinct non-trivial thresholds spill their exact
    values to the thresholds_overflow table (write_overflow_tables,
    move_structure_io.cpp:185-199) and resolve on read
    (move_structure.cpp:328-335).  The test reference has no such rows,
    so force some."""
    import dataclasses
    import struct

    ix = build_move_index(bwt_runs, "large")
    thr = ix.thr.copy()
    n64 = ix.n_arr.astype(np.int64)
    # pick rows with n >= 3 and != end/0 and force distinct non-trivials
    cand = np.flatnonzero((n64 >= 3) & (np.arange(ix.r) != ix.end_bwt_idx)
                          & (np.arange(ix.r) != 0))[:40]
    assert len(cand) >= 10
    thr[cand, 0] = 1
    thr[cand, 1] = 2
    thr[cand, 2] = (n64[cand] - 1).astype(thr.dtype)
    ix2 = dataclasses.replace(ix, thr=thr)
    p = str(tmp_path / "index.movi")
    write_movi(ix2, p)
    back = read_movi(p)
    assert np.array_equal(back.thr, thr)
    assert np.array_equal(back.n_arr, ix.n_arr)
    assert np.array_equal(back.id_arr, ix.id_arr)
    # overflow entries were actually written (exact values, u64)
    from movi_tpu.index.movi_format import _read_overflow_tables
    with open(p, "rb") as f:
        data = f.read()
    # locate the section by re-reading through the reader's own parser:
    # easiest structural check = file grew by 3*8 bytes per spilled row
    base = str(tmp_path / "plain.movi")
    write_movi(ix, base)
    assert os.path.getsize(p) == os.path.getsize(base) + len(cand) * 3 * 8


@requires_ref_data
def test_run_field_overflow_raises(bwt_runs, tmp_path):
    """Writers raise (like move_structure_build.cpp:612-617) instead of
    silently masking run fields that exceed the packed width."""
    import dataclasses

    for mode, bad_n in [("regular-thresholds", 5000), ("blocked", 2000),
                        ("sampled-thresholds", 600), ("large", 70000)]:
        ix = build_move_index(bwt_runs, mode)
        n2 = ix.n_arr.copy()
        n2[10] = bad_n
        ix2 = dataclasses.replace(ix, n_arr=n2)
        with pytest.raises(ValueError, match="run length|exceeds"):
            write_movi(ix2, str(tmp_path / f"{mode}.movi"))


@requires_ref_data
@pytest.mark.parametrize("mode", ["regular-thresholds", "large", "sampled"])
def test_split_table_mmap_pair(bwt_runs, tmp_path, mode):
    """write_movi(split_table=True) emits the reference --mmap pair
    (index.movi + rlbwt.movi, read_main_table move_structure_io.cpp:
    361-384); read_movi(mmap_table=True) memory-maps the row table and
    reproduces the identical index."""
    ix = build_move_index(bwt_runs, mode)
    p = str(tmp_path / "index.movi")
    write_movi(ix, p, split_table=True)
    rl = tmp_path / "rlbwt.movi"
    assert rl.exists()
    # rlbwt.movi holds exactly the packed table bytes from index.movi
    row_bytes = rl.read_bytes()
    assert row_bytes in (tmp_path / "index.movi").read_bytes()
    back = read_movi(p, mmap_table=True)
    for fld in ("n_arr", "offset_arr", "id_arr", "c_arr"):
        assert np.array_equal(getattr(back, fld), getattr(ix, fld)), fld
    if ix.thr is not None:
        assert np.array_equal(back.thr, ix.thr)


@requires_ref_data
def test_threshold_overflow_wide_alphabet(tmp_path):
    """Overflow entries are (sigma-1) u64 wide (move_structure_io.cpp:
    197-199), not a fixed 3 -- regression for separators-alphabet
    (sigma=5) indexes."""
    import dataclasses

    from movi_tpu.build.prepare_ref import prepare_ref
    from movi_tpu.build.suffix import build_bwt_runs
    from movi_tpu.constants import SEPARATOR

    ref = prepare_ref(os.path.join(REF_DATA, "ref.fasta"), separators=True)
    ix = build_move_index(build_bwt_runs(ref.text), "large",
                          separators=True)
    thr = ix.thr.copy()
    n64 = ix.n_arr.astype(np.int64)
    sep = ix.alphabet[ix.c_arr] == SEPARATOR
    cand = np.flatnonzero((n64 >= 4) & ~sep
                          & (np.arange(ix.r) != ix.end_bwt_idx)
                          & (np.arange(ix.r) != 0))[:20]
    assert len(cand) >= 5
    thr[cand, 0] = 1
    thr[cand, 1] = 2
    thr[cand, 2] = 3
    ix2 = dataclasses.replace(ix, thr=thr)
    p = str(tmp_path / "index.movi")
    write_movi(ix2, p)
    base = str(tmp_path / "plain.movi")
    write_movi(ix, base)
    assert (os.path.getsize(p) - os.path.getsize(base)
            == len(cand) * (ix.sigma - 1) * 8)
    back = read_movi(p)
    assert np.array_equal(back.thr, thr)
