"""movi_tpu command-line driver.

Mirrors the reference CLI surface (src/movi.cpp subcommand dispatch +
src/movi_parser.cpp flags + src/movi_launcher.cpp build orchestration):

  build        FASTA or preprocessed BWT -> index directory (prepare-ref
               + SA/BWT/thresholds + move table + null statistics),
               replacing the external pfp-thresholds/r-permute pipeline
  query        --pml/--zml/--count/--mem/--kmer[-count] with
               --classify/--filter/--multi-classify/--sa-entries/...
               (device engines auto-selected, scalar fallbacks)
  view         pretty-print a .bpf file (+ re-classification)
  inspect      index statistics (print_stats, move_structure.cpp:471-501)
  build-SA     (re)build the sampled suffix array (LF sweep)
  ftab         (re)build k-mer lookup tables
  color        (re)build Movi Color tables
  color-move-rows  write a colored index.movi
  rlbwt        preprocess a raw BWT into .heads/.len
  prepare-ref  standalone FASTA cleaner
  LF           LF micro-benchmarks
  null         (re)generate null statistics / null reads
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _log(msg: str):
    """Timestamped INFO line (commons.hpp:20-27 macro equivalent)."""
    from .commons import info

    info(msg)


def cmd_build(args):
    from .build.prepare_ref import prepare_ref
    from .build.suffix import build_bwt_runs
    from .classify import EmpNullDatabase, build_nulldb_pml, generate_null_reads
    from .cpu_ref.scalar import ScalarEngine
    from .index.structure import build_move_index
    from .build.prepare_ref import iter_fasta

    os.makedirs(args.index, exist_ok=True)
    t0 = time.time()
    fasta_paths = args.fasta
    if args.keep:
        args.keep_ref = True
    kept_bwt = os.path.join(args.index, "ref.fa.bwt")
    if (args.resume and not args.bwt_file
            and os.path.exists(kept_bwt + ".heads")):
        # stage resume from kept intermediates (the launcher's
        # --keep/--skip-prepare/--skip-pfp, movi_launcher.cpp:20-30):
        # skip prepare_ref and the suffix array entirely
        args.bwt_file = kept_bwt
        _log(f"resuming from kept intermediates at {kept_bwt}.heads/.len")
    if args.bwt_file:
        # preprocessed path: reuse a pfp_thresholds/rlbwt BWT + .thr_pos
        # (movi build --preprocessed, move_structure_build.cpp:143-202)
        from .build.suffix import runs_from_preprocessed

        runs = runs_from_preprocessed(args.bwt_file)
        ref = None
        _log(f"preprocessed BWT: n={len(runs.bwt)} "
             f"original_r={len(runs.starts)} ({time.time()-t0:.1f}s)")
    else:
        if not fasta_paths:
            raise SystemExit("build requires --fasta or --bwt-file")
        ref = prepare_ref(fasta_paths, rc=not args.fw,
                          separators=args.separators, is_list=args.list,
                          out_fasta=os.path.join(args.index, "ref.fa")
                          if args.keep_ref else None)
        _log(f"prepared reference: {len(ref.text)} bases "
             f"({time.time()-t0:.1f}s)")

        t0 = time.time()
        runs = build_bwt_runs(ref.text)
        _log(f"BWT: n={len(runs.bwt)} original_r={len(runs.starts)} "
             f"({time.time()-t0:.1f}s)")
        if args.keep:
            from .build.suffix import write_preprocessed

            write_preprocessed(runs, kept_bwt)
            with open(os.path.join(args.index, "ref.fa.doc_offsets"),
                      "w") as f:
                for off in ref.doc_offsets:
                    f.write(f"{off}\n")
            _log("kept intermediates: ref.fa.bwt.heads/.len + "
                 "ref.fa.thr_pos (+ ref.fa, doc_offsets)")

    t0 = time.time()
    from .constants import MODE_INFO

    bound_ff = args.bound_ff
    if bound_ff is None and MODE_INFO[args.type][2] and not args.movi_format:
        # NT splitting enables the fused single-gather engine (~3% rows)
        bound_ff = 1
    ix = build_move_index(runs, args.type, separators=args.separators,
                          bound_ff=bound_ff)
    _log(f"move index: r={ix.r} mode={args.type} ({time.time()-t0:.1f}s)")

    if args.movi_format:
        from .index.movi_format import write_movi

        header = ("legacy" if args.legacy_header
                  else "none" if args.no_header else "modern")
        write_movi(ix, os.path.join(args.index, "index.movi"),
                   tally_checkpoints=args.checkpoint, header=header,
                   split_table=args.mmap)
        _log("wrote reference-format index.movi"
             + (" + rlbwt.movi (mmap pair)" if args.mmap else ""))

    eng = ScalarEngine(ix)
    if args.verify:
        assert eng.verify_lf_loop(), "LF loop verification failed"
        _log("LF loop verified")

    if args.sa_entries:
        if runs.sa is not None:
            ix.sampled_SA = runs.sampled_sa(args.sa_sample_rate)
        else:
            from .index.sweeps import lf_sweep

            ix.sampled_SA, _ = lf_sweep(ix, sa_sample_rate=args.sa_sample_rate)
        ix.sa_sample_rate = args.sa_sample_rate
        _log(f"sampled SA: {len(ix.sampled_SA)} entries "
             f"(rate {args.sa_sample_rate})")

    # document metadata (always written; needed by color / multi-classify)
    if ref is not None:
        with open(os.path.join(args.index, "ref.fa.doc_offsets"), "w") as f:
            for off in ref.doc_offsets:
                f.write(f"{off}\n")

    if args.color:
        from .color import (DocumentInfo, build_color_table,
                            build_color_table_from_index,
                            compress_color_table, load_document_info)

        if ref is not None:
            di = DocumentInfo.create(ref.doc_offsets)
        else:
            # preprocessed (--bwt-file) path: no reference text in hand, so
            # document boundaries must come from an existing
            # ref.fa.doc_offsets in the index dir (the reference reads the
            # same file, move_structure_io.cpp:643-708)
            try:
                di = load_document_info(args.index)
            except FileNotFoundError:
                raise SystemExit(
                    "build --bwt-file --color needs ref.fa.doc_offsets in "
                    "the index directory (run prepare-ref first)")
        if runs.sa is not None:
            ct = build_color_table(ix, runs.sa, di)
        else:
            # no suffix array on the preprocessed path: derive doc_pats by
            # the O(n) LF sweep, like build_doc_pats
            # (move_structure_color.cpp:4-24)
            ct = build_color_table_from_index(ix, di)
        if args.compress_colors:
            ct = compress_color_table(ct)
        if args.tree_compress_colors:
            from .lca import tree_compress_color_table

            ct = tree_compress_color_table(ct, ix.r)
        ct.save(os.path.join(args.index, "colors.npz"))
        ct.save_reference(args.index,
                          compressed=(args.compress_colors
                                      or args.tree_compress_colors),
                          flat=True)
        _log(f"colors: {len(ct.unique_doc_sets)} unique doc sets over "
             f"{di.num_docs} documents")

    ix.save(os.path.join(args.index, "index.npz"))
    from .commons import success

    success(f"The index is built and stored in {args.index}")
    if args.mmap:
        ix.save_mmap(os.path.join(args.index, "index.mmap"))
        _log("wrote mmap layout index.mmap/")
    if args.fused_cache or args.paired_cache:
        from .engine.fused import build_fused_index, save_fused_index

        fi_c = build_fused_index(ix)
        save_fused_index(fi_c,
                         os.path.join(args.index, "fused_records.npz"))
        _log("wrote fused step records (query startup skips the rebuild)")
        if args.paired_cache:
            from .engine.fused2 import (build_fused2_index,
                                        save_fused2_index)

            save_fused2_index(build_fused2_index(fi_c),
                              os.path.join(args.index,
                                           "paired_records.npz"))
            _log("wrote paired step records (query --paired-records "
                 "skips the compose)")
            from .engine.fused_search2 import (build_fused_search2_index,
                                               save_fused_search2_index)

            save_fused_search2_index(
                build_fused_search2_index(ix),
                os.path.join(args.index, "paired_search_records.npz"))
            _log("wrote paired search records (count/zml "
                 "--paired-records skips the compose)")

    if args.ftab_k > 1:
        from .cpu_ref.advanced import AdvancedEngine

        aeng = AdvancedEngine(ix, ftab_k=args.ftab_k)
        np.save(os.path.join(args.index, f"ftab.{args.ftab_k}.npy"),
                aeng.ftab)
        _log(f"ftab (k={args.ftab_k}) written")

    if not args.skip_null and fasta_paths:
        # PML and ZML null statistics, like the reference build
        # (movi.cpp:621-634)
        records = []
        for p in (fasta_paths if isinstance(fasta_paths, list) else [fasta_paths]):
            records.extend(iter_fasta(p))
        random_rep = ix.thr is None
        db = build_nulldb_pml(
            ix, lambda s: eng.query_pml(s, random_repositioning=random_rep),
            records, seed=args.seed,
            null_reads_path=os.path.join(args.index, "null_reads.fasta"))
        db.save(os.path.join(args.index, "movi.pml.nulldb"))
        _log(f"pml null statistics: percentile={db.percentile_value}")
        dbz = build_nulldb_pml(ix, eng.query_zml, records, seed=args.seed)
        dbz.save(os.path.join(args.index, "movi.zml.nulldb"))
        _log(f"zml null statistics: percentile={dbz.percentile_value}")
    _log("build done")


def _load_index(index_dir, mmap=False, resplit=True):
    """Load index.npz (native) or a reference-built index.movi, like the
    launcher's header-byte dispatch (movi_launcher.cpp:408-434).  With
    mmap=True, demand-page the row arrays from an index.mmap/ layout
    (the reference's --mmap, move_structure_io.cpp:361-397).

    A reference-built index.movi lacks the bound_ff=1 invariant the
    fused engines need; by default it is NT re-split at load time
    (index/resplit.py) so such indexes run the fast engines too, like
    the reference launcher guaranteeing every index its fast path
    (movi_launcher.cpp:408-434).  Disable with resplit=False
    (--no-resplit)."""
    from .index.structure import MoveIndex

    mmap_dir = os.path.join(index_dir, "index.mmap")
    if mmap and os.path.isdir(mmap_dir):
        return MoveIndex.load_mmap(mmap_dir)
    npz = os.path.join(index_dir, "index.npz")
    movi = os.path.join(index_dir, "index.movi")
    rlbwt = os.path.join(index_dir, "rlbwt.movi")
    if mmap and os.path.exists(movi) and os.path.exists(rlbwt):
        # reference --mmap pair: map the packed row table from
        # rlbwt.movi (read_main_table, move_structure_io.cpp:361-384)
        from .index.movi_format import read_movi

        return read_movi(movi, mmap_table=True)
    if mmap:
        _log("no index.mmap/ layout or rlbwt.movi pair found; loading "
             "index normally (build with --mmap to enable)")
    if os.path.exists(npz):
        return MoveIndex.load(npz)
    if os.path.exists(movi):
        from .index.movi_format import read_movi

        ix = read_movi(movi)
        if resplit and not ix.separators:
            from .index.resplit import needs_resplit, resplit_index

            if needs_resplit(ix):
                r_old = ix.r
                ix = resplit_index(ix)
                _log(f"re-split reference-format index for the fused "
                     f"engines (r {r_old} -> {ix.r}); --no-resplit to "
                     f"keep the original rows")
        return ix
    raise SystemExit(f"no index found in {index_dir}")


def _apply_ignore_illegal(ix, reads, mode, seed=0):
    """Host-side --ignore-illegal-chars substitution (check_alphabet,
    move_structure.cpp:383-397): mode 1 maps illegal chars to 'A',
    mode 2 to a seeded-random base.  Randoms are drawn per read in
    right-to-left order -- the scalar engine's processing order -- so
    every downstream engine (device or scalar) produces the output
    ScalarEngine(ignore_illegal_chars=mode, seed=seed) would."""
    from .constants import SEPARATOR

    rng = np.random.default_rng(seed)
    keep = np.zeros(256, dtype=bool)
    keep[ix.alphabet] = True
    if ix.separators:
        keep[SEPARATOR] = True  # separators pass through unsubstituted
    out = []
    for name, seq in reads:
        arr = np.frombuffer(seq, np.uint8).copy()
        bad = np.flatnonzero(~keep[arr])
        if len(bad):
            if mode == 1:
                arr[bad] = ord("A")
            else:
                for p in bad[::-1]:
                    arr[p] = ix.alphabet[rng.integers(0, ix.sigma)]
        out.append((name, arr.tobytes()))
    return out


def _load_color_table(index_dir, ix):
    """Load the Movi Color tables like load_color_table
    (movi.cpp:120-150): prefer the native colors.npz; else the embedded
    colored rows (index_colored.movi, whose 12 B rows carry the per-run
    color id -- add_colors_to_rlbwt, move_structure_color.cpp:352-374)
    plus a doc_sets binary for the set contents; else the reference
    doc_sets binaries (doc_sets.bin / compress_doc_sets.bin /
    doc_sets_flat.bin) with per-run indices."""
    from .color import ColorTable, load_document_info

    npz = os.path.join(index_dir, "colors.npz")
    if os.path.exists(npz):
        return ColorTable.load(npz)
    di = load_document_info(index_dir)
    colored = os.path.join(index_dir, "index_colored.movi")
    if os.path.exists(colored):
        from .index.movi_format import read_doc_sets_bin, read_movi_colored

        _, color_ids = read_movi_colored(colored)
        for name in ("doc_sets.bin", "compress_doc_sets.bin",
                     "tree_doc_sets.bin"):
            p = os.path.join(index_dir, name)
            if os.path.exists(p):
                # COLOR_MODE == 1 readers skip the per-run indices --
                # they live in the colored rows (move_structure_io.cpp:
                # 630-633)
                sets, _ = read_doc_sets_bin(p, ix.r, with_inds=False)
                return ColorTable(doc_pats=None, doc_set_inds=color_ids,
                                  unique_doc_sets=sets, doc_info=di)
    return ColorTable.load_reference(index_dir, ix.r, di, length=ix.length)


def _query_type(args):
    if args.pml:
        return "pml"
    if args.zml:
        return "zml"
    if args.count:
        return "count"
    if args.mem:
        return "mems"
    if args.kmer or args.kmer_count:
        return "kmers"
    raise SystemExit("specify one of --pml/--zml/--count/--mem/--kmer")


def _paired_force(args):
    """--paired-records forces the paired engines, --no-paired-records
    the one-step ones; default None = capacity auto-selection
    (engine/select.py)."""
    if getattr(args, "paired_records", False):
        return True
    if getattr(args, "no_paired_records", False):
        return False
    return None


def cmd_query(args):
    from .commons import timing
    from .io.fastx import iter_fastx, make_batches
    from .io.outputs import BPFWriter, count_line, pml_stdout_lines

    if args.profile:
        # device tracing (the analogue of the reference's --logs chrono
        # sampling): wraps the whole query in a profiler trace viewable
        # with tensorboard/xprof
        import jax as _jax

        _jax.profiler.start_trace(args.profile)
        try:
            args.profile = ""
            cmd_query(args)
        finally:
            _jax.profiler.stop_trace()
        _log("profiler trace written")
        return

    ix = _load_index(args.index, mmap=args.mmap,
                     resplit=not args.no_resplit)
    qt = _query_type(args)
    reads = list(iter_fastx(args.read))
    if args.reverse:
        reads = [(n, s[::-1]) for n, s in reads]
    if args.ignore_illegal_chars:
        # --ignore-illegal-chars is host-side read preprocessing
        # (check_alphabet, move_structure.cpp:383-397), applied before
        # batching so the DEVICE engines honor it too; mode-2 randoms
        # are drawn in the scalar engine's processing order (per read,
        # right to left) so device output stays bit-identical to
        # ScalarEngine with the same seed.
        reads = _apply_ignore_illegal(ix, reads,
                                      args.ignore_illegal_chars)

    if args.logs:
        args.no_jax = True  # per-base cost tracing runs on the scalar path

    if args.sa_entries and qt == "pml" and not args.no_jax:
        # device PML + per-base SA entries (fused scan emits the pre-LF
        # state; masked lockstep walk to the nearest sampled row)
        lf_abs = ix.all_p[ix.id_arr] + ix.offset_arr
        e = lf_abs + ix.n_arr - 1
        id_end = np.searchsorted(ix.all_p[:-1], e, side="right") - 1
        if (int((id_end - ix.id_arr).max()) <= 1 and ix.thr is not None
                and ix.sampled_SA is not None):
            from .engine.fused import build_fused_index
            from .engine.fused_sa import FusedSAEngine
            from .io.fastx import make_batches as _mb

            _log("using the fused SA-entries engine")
            eng = FusedSAEngine(build_fused_index(ix), ix)
            results, sa_results = [], []
            with timing("device queries"):
                for batch in _mb(reads, lanes=args.lanes):
                    for name, (pmls, sas) in zip(batch.names,
                                                 eng.query_batch(batch)):
                        results.append((name, pmls))
                        sa_results.append((name, sas))
            if not args.no_output:
                out_sa = (args.out_file or f"{args.read}.{ix.mode}") + \
                    ".pml.sa_entries.bpf"
                with BPFWriter(out_sa, entry_size=64) as w:
                    for name, sas in sa_results:
                        w.write_read(name, sas)
                _log(f"wrote {out_sa}")
                out_prefix = (args.out_file or
                              f"{args.read}.{ix.mode}") + ".pml"
                with BPFWriter(out_prefix + ".bpf") as w:
                    for name, pmls in results:
                        w.write_read(name, pmls)
                _log(f"wrote {out_prefix}.bpf")
            elif args.stdout:
                from .io.outputs import pml_stdout_lines

                for name, pmls in results:
                    for ln in pml_stdout_lines(name, pmls):
                        print(ln)
            return
        args.no_jax = True  # fall back to the scalar SA path
    elif args.sa_entries:
        args.no_jax = True

    if args.multi_classify:
        from .color import ColorEngine, ColorTable

        ct = _load_color_table(args.index, ix)
        report_colors = args.report_colors or args.report_color_ids
        out_path = (args.out_file
                    or f"{args.read}.{ix.mode}.multiclass.csv")
        lines = []
        color_lines = []

        # device path: the fused scan additionally emits per-base color
        # ids; host tallies votes (engine/fused_color.py).  --early-stop
        # retires lanes from the emitted streams (bit-equal to the
        # scalar break) so it stays on device too.
        lf_abs = ix.all_p[ix.id_arr] + ix.offset_arr
        e = lf_abs + ix.n_arr - 1
        id_end = np.searchsorted(ix.all_p[:-1], e, side="right") - 1
        bounded = int((id_end - ix.id_arr).max()) <= 1
        use_device = (not args.no_jax and bounded and ix.thr is not None)
        if use_device:
            from .io.fastx import make_batches as _mb

            color_kw = dict(
                min_match_len=args.min_match_len,
                pvalue_scoring=args.pvalue_scoring,
                report_all=args.report_all,
                min_diff_frac=args.min_diff_frac,
                min_score_frac=args.min_score_frac,
                early_stop=args.early_stop)
            from .engine.select import use_paired_color

            if use_paired_color(ix.r, ix.sigma, len(ct.unique_doc_sets),
                                force=_paired_force(args)):
                from .engine.fused import build_fused_index
                from .engine.fused2 import (Fused2ColorEngine,
                                            build_fused2_color_index)

                _log("using the paired color engine "
                     "(one gather per two bases)")
                eng = Fused2ColorEngine(
                    build_fused2_color_index(build_fused_index(ix), ct),
                    ct, **color_kw)
            else:
                from .engine.fused_color import (FusedColorEngine,
                                                 build_fused_color_index)

                _log("using the fused color engine")
                eng = FusedColorEngine(
                    build_fused_color_index(ix, ct), ct, **color_kw)
            with timing("device queries"):
                for batch in _mb(reads, lanes=args.lanes):
                    out = eng.query_batch(batch)
                    for name, (pmls, cell, cols) in zip(batch.names, out):
                        lines.append(f"{name},{cell}")
                        if report_colors:
                            color_lines.append(
                                ">" + name + "\n"
                                + " ".join(str(c) for c in reversed(cols)))
        else:
            eng = ColorEngine(ix, ct, min_match_len=args.min_match_len,
                              pvalue_scoring=args.pvalue_scoring,
                              report_all=args.report_all,
                              min_diff_frac=args.min_diff_frac,
                              min_score_frac=args.min_score_frac,
                              report_colors=report_colors,
                              early_stop=args.early_stop)
            for name, seq in reads:
                pmls, cell = eng.query_pml_multiclass(seq)
                lines.append(f"{name},{cell}")
                if report_colors:
                    color_lines.append(
                        ">" + name + "\n"
                        + " ".join(str(c) for c in reversed(eng.last_colors)))
        if report_colors and not args.no_output:
            cpath = f"{args.read}.{ix.mode}.colors"
            with open(cpath, "w") as f:
                for ln in color_lines:
                    f.write(ln + "\n")
            _log(f"wrote {cpath}")
        if args.lca_tree:
            from .lca import lca_postprocess, load_nodes_dmp

            lines = lca_postprocess(lines, load_nodes_dmp(args.lca_tree))
        if args.stdout:
            for ln in lines:
                print(ln)
        elif not args.no_output:
            with open(out_path, "w") as f:
                for ln in lines:
                    f.write(ln + "\n")
            _log(f"wrote {out_path}")
        return

    if qt == "kmers" and not args.kmer_count and not args.no_jax:
        # device k-mer membership engine (bounded index required)
        lf_abs = ix.all_p[ix.id_arr] + ix.offset_arr
        e = lf_abs + ix.n_arr - 1
        id_end = np.searchsorted(ix.all_p[:-1], e, side="right") - 1
        if int((id_end - ix.id_arr).max()) <= 1:
            from .engine.fused_kmer import FusedKmerEngine
            from .engine.fused_search import build_fused_search_index
            from .io.fastx import make_batches as _mb

            # ftab anchor rows (gated to the instant-probe-fail bound
            # fk <= k - k/3; ACGT only)
            fk = 0
            if bytes(ix.alphabet) == b"ACGT":
                fk = min(args.ftab_k or 10, args.k - args.k // 3)
            _log(f"using the fused kmer engine"
                 + (f" (ftab-{fk})" if fk > 1 else ""))
            eng = FusedKmerEngine(
                build_fused_search_index(ix, ftab_k=fk), args.k)
            lines = []
            with timing("device queries"):
                for batch in _mb(reads, lanes=args.lanes):
                    out = eng.query_batch(batch)
                    for name, L, spans in zip(batch.names, batch.lengths, out):
                        L = int(L)
                        found = sum(c for _, c in spans)
                        span_s = " ".join(f"{p}:{c}" for p, c in spans)
                        span_s += " " if spans else ""
                        lines.append(
                            f"{name}\t{found}/{L - args.k + 1}\t{span_s}")
            if args.stdout:
                for ln in lines:
                    print(ln)
            elif not args.no_output:
                out = f"{args.read}.{ix.mode}.kmers.{args.k}"
                with open(out, "w") as f:
                    for ln in lines:
                        f.write(ln + "\n")
                _log(f"wrote {out}")
            return

    if qt == "mems" and not args.no_jax:
        # device MEM engines (bounded ACGT index required): BML for
        # min lengths >= 2, the all-MEMs machine otherwise
        lf_abs = ix.all_p[ix.id_arr] + ix.offset_arr
        e = lf_abs + ix.n_arr - 1
        id_end = np.searchsorted(ix.all_p[:-1], e, side="right") - 1
        if (int((id_end - ix.id_arr).max()) <= 1
                and bytes(ix.alphabet) == b"ACGT"):
            from .io.fastx import make_batches as _mb
            from .io.outputs import mem_lines

            from .engine.fused_mem2 import mem2_supported

            if not mem2_supported(ix):
                # large-n fallback: the v1 machines cap/skip pos2rba
                from .engine.fused_mem import (FusedAllMemEngine,
                                               FusedMemEngine,
                                               build_fused_mem_index)

                _log("using the fused MEM engine (v1, large-n)")
                mi = build_fused_mem_index(ix)
                eng = (FusedMemEngine(mi, args.min_mem_length)
                       if args.min_mem_length >= 2
                       else FusedAllMemEngine(mi))
            elif args.min_mem_length >= 2:
                # BML runs on the v2 one-gather-per-tick records, with
                # an ftab anchor jumping the first fk BACK steps
                # (mem_finder.cpp:34-43); --ftab-k overrides the width
                from .engine.fused_mem2 import (FusedMem2Engine,
                                                build_fused_mem2_index)

                fk = min(args.ftab_k or 10, args.min_mem_length)
                _log(f"using the fused MEM engine (v2, ftab-{fk})")
                eng = FusedMem2Engine(
                    build_fused_mem2_index(ix, ftab_k=fk),
                    args.min_mem_length)
            else:
                from .engine.fused_mem2 import (FusedAllMem2Engine,
                                                build_fused_mem2_index)

                _log("using the fused all-MEMs engine (v2)")
                eng = FusedAllMem2Engine(build_fused_mem2_index(ix))
            lines = []
            with timing("device queries"):
                for batch in _mb(reads, lanes=args.lanes):
                    for name, mems in zip(batch.names, eng.query_batch(batch)):
                        lines.extend(mem_lines(name, mems))
            if args.stdout:
                for ln in lines:
                    print(ln)
            elif not args.no_output:
                out = f"{args.read}.{ix.mode}.mems"
                with open(out, "w") as f:
                    for ln in lines:
                        f.write(ln + "\n")
                _log(f"wrote {out}")
            return

    if qt == "kmers" and args.kmer_count and not args.no_jax:
        lf_abs = ix.all_p[ix.id_arr] + ix.offset_arr
        e = lf_abs + ix.n_arr - 1
        id_end = np.searchsorted(ix.all_p[:-1], e, side="right") - 1
        if int((id_end - ix.id_arr).max()) <= 1:
            from .engine.select import use_paired_search
            from .io.fastx import make_batches as _mb

            # the bidirectional k/2-cache engine needs an rc-complete
            # ACGT index (sequitur.cpp:7-9); detected by checking ALL
            # 4^6 6-mer counts against their reverse complements'
            from .engine.fused_mem2 import looks_rc_closed

            rc_sym = looks_rc_closed(ix)
            if rc_sym and use_paired_search(ix.r, ix.sigma,
                                            force=_paired_force(args)):
                from .engine.fused_kmer2 import FusedKmer2CountEngine
                from .engine.fused_mem2 import build_fused_mem2_index
                from .engine.fused_search2 import (
                    build_fused_search2_index)

                _log("using the bidirectional kmer-count engine "
                     "(k/2 partial-interval cache)")
                eng = FusedKmer2CountEngine(
                    build_fused_mem2_index(ix),
                    build_fused_search2_index(ix), args.k)
            elif use_paired_search(ix.r, ix.sigma,
                                   force=_paired_force(args)):
                from .engine.fused_search2 import (
                    Fused2KmerCountEngine, build_fused_search2_index)

                _log("using the paired kmer-count engine")
                eng = Fused2KmerCountEngine(
                    build_fused_search2_index(ix), args.k)
            else:
                from .engine.fused_kmer import FusedKmerCountEngine
                from .engine.fused_search import build_fused_search_index

                _log("using the fused kmer-count engine")
                eng = FusedKmerCountEngine(
                    build_fused_search_index(ix), args.k)
            lines = []
            with timing("device queries"):
                for batch in _mb(reads, lanes=args.lanes):
                    out = eng.query_batch(batch)
                    for name, L, (found, total) in zip(
                            batch.names, batch.lengths, out):
                        lines.append(
                            f"{name}\t{found}/{int(L) - args.k + 1}\t{total}")
            if args.stdout:
                for ln in lines:
                    print(ln)
            elif not args.no_output:
                out = f"{args.read}.{ix.mode}.kmers.{args.k}"
                with open(out, "w") as f:
                    for ln in lines:
                        f.write(ln + "\n")
                _log(f"wrote {out}")
            return

    if qt in ("mems", "kmers"):
        from .cpu_ref.advanced import AdvancedEngine
        from .io.outputs import mem_lines

        ftab_path = os.path.join(args.index, f"ftab.{args.ftab_k}.npy")
        if args.multi_ftab and args.ftab_k > 1:
            eng = AdvancedEngine(ix, ftab_k=args.ftab_k, multi_ftab=True)
        else:
            eng = AdvancedEngine(ix, ftab_k=0)
            if args.ftab_k > 1:
                bin_path = os.path.join(args.index,
                                        f"ftab.{args.ftab_k}.bin")
                if os.path.exists(ftab_path):
                    eng.ftab = np.load(ftab_path)
                    eng.ftab_k = args.ftab_k
                elif os.path.exists(bin_path):
                    from .index.movi_format import read_ftab_bin

                    _, eng.ftab = read_ftab_bin(bin_path)
                    eng.ftab_k = args.ftab_k
                else:
                    eng.build_ftab(args.ftab_k)
        lines = []
        for name, seq in reads:
            if qt == "mems":
                mems = eng.query_mems(seq, args.min_mem_length)
                lines.extend(mem_lines(name, mems))
            elif args.kmer_count:
                found, total = eng.count_kmers_bidirectional(seq, args.k)
                lines.append(f"{name}\t{found}/{len(seq) - args.k + 1}\t{total}")
            else:
                spans = eng.query_all_kmers(seq, args.k)
                found = sum(c for _, c in spans)
                span_s = " ".join(f"{p}:{c}" for p, c in spans) + (" " if spans else "")
                lines.append(f"{name}\t{found}/{len(seq) - args.k + 1}\t{span_s}")
        if args.stdout:
            for ln in lines:
                print(ln)
        elif not args.no_output:
            suffix = "" if qt == "mems" else f".{args.k}"
            out = f"{args.read}.{ix.mode}.{qt}{suffix}"
            with open(out, "w") as f:
                for ln in lines:
                    f.write(ln + "\n")
            _log(f"wrote {out}")
        if qt == "kmers":
            for ln in eng.kmer_stats.summary().splitlines():
                _log(ln)
        return

    use_jax = not args.no_jax
    results = []
    if use_jax:
        # fused engines apply when the index satisfies the bounded
        # fast-forward invariant (built with bound_ff=1)
        lf_abs = ix.all_p[ix.id_arr] + ix.offset_arr
        e = lf_abs + ix.n_arr - 1
        id_end = np.searchsorted(ix.all_p[:-1], e, side="right") - 1
        bounded = int((id_end - ix.id_arr).max()) <= 1

        eng = None
        from .engine.select import pick_backend

        backend = pick_backend(ix.r, ix.sigma,
                               "pml" if qt == "pml" else "search",
                               force_paired=_paired_force(args))
        if backend == "compact":
            from .commons import warning

            warning(
                f"index (r={ix.r}) exceeds the single-chip record-table "
                f"budget; falling back to the compact engine.  A model-"
                f"sharded mesh runs the fused layout at full speed "
                f"(parallel/sharded_index.py; engine/select.pick_backend)")
        if (qt == "pml" and ix.thr is not None and bounded
                and not args.rpml and backend != "compact"):
            from .engine.fused import (FusedPMLEngine, build_fused_index,
                                       load_fused_index)

            from .engine.fused import save_fused_index

            cache = os.path.join(args.index, "fused_records.npz")
            fi = None
            if os.path.exists(cache):
                try:
                    fi = load_fused_index(cache)
                except ValueError as e:
                    from .commons import warning

                    warning(f"{e}; rebuilding fused records")
            if fi is None:
                fi = build_fused_index(ix)
                if os.path.exists(cache):
                    save_fused_index(fi, cache)  # refresh the stale cache
            from .engine.select import use_paired_pml

            if use_paired_pml(ix.r, ix.sigma, force=_paired_force(args)):
                from .engine.fused2 import (Fused2PMLEngine,
                                            build_fused2_index,
                                            load_fused2_index)

                cache2 = os.path.join(args.index, "paired_records.npz")
                f2 = None
                if os.path.exists(cache2):
                    try:
                        f2 = load_fused2_index(cache2)
                    except ValueError as e:
                        from .commons import warning

                        warning(f"{e}; recomposing")
                if f2 is None:
                    f2 = build_fused2_index(fi)
                eng = Fused2PMLEngine(f2)
                _log("using the paired-record engine "
                     "(one gather per two bases)")
            else:
                eng = FusedPMLEngine(fi)
                _log("using the fused single-gather engine")
        elif qt in ("count", "zml") and bounded and backend != "compact":
            from .engine.select import use_paired_search

            if use_paired_search(ix.r, ix.sigma,
                                 force=_paired_force(args)):
                from .engine.fused_search2 import (
                    Fused2CountEngine, Fused2ZMLEngine,
                    build_fused_search2_index, load_fused_search2_index)

                cache2 = os.path.join(args.index,
                                      "paired_search_records.npz")
                s2 = None
                if os.path.exists(cache2):
                    try:
                        s2 = load_fused_search2_index(cache2)
                    except ValueError as e:
                        from .commons import warning

                        warning(f"{e}; recomposing")
                if s2 is None:
                    s2 = build_fused_search2_index(ix)
                eng = (Fused2CountEngine(s2) if qt == "count"
                       else Fused2ZMLEngine(s2))
                _log("using the paired search engine "
                     "(one record gather per base)")
            else:
                from .engine.fused_search import (FusedCountEngine,
                                                  FusedZMLEngine,
                                                  build_fused_search_index)

                si = build_fused_search_index(ix)
                eng = (FusedCountEngine(si) if qt == "count"
                       else FusedZMLEngine(si))
                _log("using the fused search engine")
        if eng is None:
            from .engine.device_index import build_device_index
            from .engine.pml import PMLEngine
            from .engine.search import CountEngine, ZMLEngine

            di = build_device_index(ix)
            if qt == "pml":
                eng = PMLEngine(di, random_repositioning=args.rpml
                                or ix.thr is None)
            elif qt == "zml":
                eng = ZMLEngine(di)
            else:
                eng = CountEngine(di)
        with timing("device queries"):
            for batch in make_batches(reads, lanes=args.lanes):
                out = eng.query_batch(batch)
                results.extend(zip(batch.names, out))
    else:
        from .cpu_ref.scalar import ScalarEngine

        rand_rep = args.rpml or ix.thr is None
        if args.logs and qt == "pml":
            from .logs import LoggingScalarEngine, write_log_files

            leng = LoggingScalarEngine(ix)
            log_entries = []
            for name, seq in reads:
                pmls, qlogs = leng.query_pml_logged(seq)
                results.append((name, pmls))
                log_entries.append((name, qlogs))
            write_log_files(f"{args.read}.{ix.mode}.{qt}", log_entries)
            _log(f"wrote {args.read}.{ix.mode}.{qt}"
                 ".{costs,scans,fastforwards}")
        else:
            from .commons import read_progress

            eng = ScalarEngine(
                ix, ignore_illegal_chars=args.ignore_illegal_chars)
            sa_results = []
            for read_i, (name, seq) in enumerate(reads):
                read_progress(read_i)  # movi.cpp:343-345
                if qt == "pml":
                    if args.sa_entries:
                        pmls, sas = eng.query_pml(
                            seq, random_repositioning=rand_rep,
                            collect_sa=True)
                        results.append((name, pmls))
                        sa_results.append((name, sas))
                    else:
                        results.append(
                            (name, eng.query_pml(
                                seq, random_repositioning=rand_rep)))
                elif qt == "zml":
                    results.append((name, eng.query_zml(seq)))
                else:
                    results.append((name, eng.query_count(seq)))
            if args.sa_entries and sa_results and not args.no_output:
                out_sa = (args.out_file or f"{args.read}.{ix.mode}") + \
                    f".{qt}.sa_entries.bpf"
                with BPFWriter(out_sa, entry_size=64) as w:
                    for name, sas in sa_results:
                        w.write_read(name, sas)
                _log(f"wrote {out_sa}")

    # classification
    classifier = None
    report_lines = []
    found_list = []  # positional, aligned with reads/results
    if args.classify:
        from .classify import (Classifier, EmpNullDatabase,
                               format_report_header, format_report_line)

        db = EmpNullDatabase.load(os.path.join(args.index,
                                               f"movi.{qt}.nulldb"))
        classifier = Classifier(db, bin_width=args.bin_width)
        report_lines.append(format_report_header(classifier.max_value_thr))

    index_type = ix.mode
    out_prefix = (args.out_file if args.out_file
                  else f"{args.read}.{index_type}") + f".{qt}"

    # results are index-aligned with reads (batches preserve order), so
    # read lengths pair positionally -- duplicate read NAMES are legal in
    # fastq and must each report their own length in .matches lines
    lines_out = []
    for (name, res), (_, seq) in zip(results, reads):
        if qt in ("pml", "zml"):
            if classifier:
                found, avg, above, below = classifier.classify(res)
                found_list.append(found)
                from .classify import format_report_line
                report_lines.append(
                    format_report_line(name, found, avg, above, below))
            if args.stdout:
                lines_out.extend(pml_stdout_lines(name, res))
        else:
            pos, cnt = res
            lines_out.append(count_line(name, len(seq), pos, cnt))

    if args.filter and classifier:
        for (name, seq), f in zip(reads, found_list):
            if (f and not args.invert) or (not f and args.invert):
                print(f">{name}")
                print(seq.decode())
    elif args.stdout:
        for ln in lines_out:
            print(ln)
    elif not args.no_output:
        if qt in ("pml", "zml"):
            with BPFWriter(out_prefix + ".bpf") as w:
                for name, res in results:
                    w.write_read(name, res)
            _log(f"wrote {out_prefix}.bpf")
        else:
            with open(out_prefix + ".matches", "w") as f:
                for ln in lines_out:
                    f.write(ln + "\n")
            _log(f"wrote {out_prefix}.matches")

    if classifier and not args.filter:
        if args.stdout:
            for ln in report_lines:
                print(ln)
        elif not args.no_output:
            rpath = f"{args.read}.{index_type}.{qt}.report"
            with open(rpath, "w") as f:
                for ln in report_lines:
                    f.write(ln + "\n")
            _log(f"wrote {rpath}")


def cmd_build_sa(args):
    """`build-SA`: (re)build the sampled SA from the index alone via an
    O(n) LF sweep (movi.cpp:640-645; move_structure_build.cpp:1173-1212)."""
    from .index.sweeps import lf_sweep

    ix = _load_index(args.index)
    sa, _ = lf_sweep(ix, sa_sample_rate=args.sample_rate)
    ix.sampled_SA = sa
    ix.sa_sample_rate = args.sample_rate
    ix.save(os.path.join(args.index, "index.npz"))
    from .index.movi_format import write_ssa

    write_ssa(ix, os.path.join(args.index, "ssa.movi"))
    _log(f"sampled SA: {len(sa)} entries (rate {args.sample_rate}); "
         "wrote ssa.movi")


def cmd_ftab(args):
    """`ftab`: (re)build the k-mer lookup table from an existing index
    (movi.cpp:728-731; build_ftab move_structure_build.cpp:1121-1171)."""
    from .cpu_ref.advanced import AdvancedEngine

    ix = _load_index(args.index)
    ks = ([args.ftab_k] if not args.multi_ftab
          else [k for k in range(args.ftab_k, 1, -2)])
    from .index.movi_format import write_ftab_bin

    for k in ks:
        eng = AdvancedEngine(ix, ftab_k=k)
        np.save(os.path.join(args.index, f"ftab.{k}.npy"), eng.ftab)
        write_ftab_bin(eng.ftab, k, os.path.join(args.index,
                                                 f"ftab.{k}.bin"))
        _log(f"ftab (k={k}) written (.npy + reference .bin)")


def cmd_color(args):
    """`color`: build the color table for an existing index
    (movi.cpp:646-654, color() :167-219).  doc_pats come from an O(n)
    LF sweep; with --full they are persisted alongside the doc sets."""
    from .color import (build_color_table_from_index, compress_color_table,
                        load_document_info)

    ix = _load_index(args.index)
    di = load_document_info(args.index)
    ct = build_color_table_from_index(ix, di)
    if args.full:
        np.save(os.path.join(args.index, "doc_pats.npy"), ct.doc_pats)
        _log("doc_pats written")
    if args.compress:
        ct = compress_color_table(ct)
        _log(f"frequency-compressed to {len(ct.unique_doc_sets)} sets")
    if args.tree_compress:
        from .lca import tree_compress_color_table

        ct = tree_compress_color_table(ct, ix.r)
        _log("tree-compressed")
    ct.save(os.path.join(args.index, "colors.npz"))
    ct.save_reference(args.index,
                      compressed=args.compress or args.tree_compress,
                      flat=True)
    _log(f"colors: {len(ct.unique_doc_sets)} unique doc sets over "
         f"{di.num_docs} documents (npz + reference .bin files)")


def cmd_rlbwt(args):
    """`rlbwt`: preprocess a raw BWT file into run-length form —
    .bwt.heads (chars) + .bwt.len (5-byte little-endian lengths), exactly
    the reference's format (build_rlbwt, movi.cpp:505-559)."""
    import struct

    bwt = np.fromfile(args.bwt_file, dtype=np.uint8)
    if len(bwt) == 0:
        raise SystemExit(f"empty BWT file: {args.bwt_file}")
    bounds = np.flatnonzero(np.diff(bwt)) + 1
    starts = np.concatenate([[0], bounds])
    lens = np.diff(np.concatenate([starts, [len(bwt)]]))
    with open(args.bwt_file + ".heads", "wb") as hf:
        hf.write(bwt[starts].tobytes())
    with open(args.bwt_file + ".len", "wb") as lf:
        for ln in lens:
            lf.write(struct.pack("<Q", int(ln))[:5])
    _log(f"rlbwt: {len(starts)} runs over {len(bwt)} bases")


def cmd_color_move_rows(args):
    """`color-move-rows`: embed per-run color ids into the serialized
    rows (add_colors_to_rlbwt, move_structure_color.cpp:352-374 +
    MoveRowColored move_row_colored.hpp), written as a
    reference-compatible colored index.movi."""
    from .color import ColorTable
    from .index.movi_format import write_movi_colored

    ix = _load_index(args.index)
    ct = ColorTable.load(os.path.join(args.index, "colors.npz"))
    out = os.path.join(args.index, "index_colored.movi")
    write_movi_colored(ix, np.asarray(ct.doc_set_inds), out)
    _log(f"wrote {out}")


def cmd_prepare_ref(args):
    """`prepare-ref`: standalone FASTA cleaner (prepare_ref.cpp:16-131)."""
    from .build.prepare_ref import prepare_ref

    ref = prepare_ref(args.fasta, rc=not args.fw,
                      separators=args.separators, is_list=args.list,
                      out_fasta=args.output)
    with open(args.output + ".doc_offsets", "w") as f:
        for off in ref.doc_offsets:
            f.write(f"{off}\n")
    _log(f"prepared {args.output}: {len(ref.text)} bases, "
         f"{len(ref.doc_offsets)} documents")


def cmd_view(args):
    """BPF pretty-printer + optional re-classification (movi.cpp:402-503)."""
    from .io.outputs import read_bpf

    classifier = None
    report_lines = []
    if args.classify:
        from .classify import (Classifier, EmpNullDatabase,
                               format_report_header, format_report_line)

        db = EmpNullDatabase.load(args.nulldb)
        classifier = Classifier(db, bin_width=args.bin_width)
        report_lines.append(format_report_header(classifier.max_value_thr))

    hint = 16 if args.small_bpf else (64 if args.large_bpf else 32)
    for name, vals in read_bpf(args.mls_file, entry_size_hint=hint):
        if classifier:
            from .classify import format_report_line

            found, avg, above, below = classifier.classify(vals)
            report_lines.append(
                format_report_line(name, found, avg, above, below))
        else:
            print(f">{name}")
            print(" ".join(str(v) for v in reversed(vals)) + " ")
    for ln in report_lines:
        print(ln)


def _output_ids(ix, index_dir):
    """ids.all + per-character ids.<c> dumps of the character-adjusted LF
    destination of every run (output_ids, move_structure_io.cpp:834-868)."""
    base = os.path.join(index_dir, "ids")
    mask = np.ones(ix.r, dtype=bool)
    mask[ix.end_bwt_idx] = False
    adjusted = ix.id_arr - ix.first_runs[ix.c_arr.astype(np.int64) + 1]
    run_idx = np.arange(ix.r)
    with open(base + ".all", "w") as f:
        f.write("\n".join(map(str, adjusted[mask])) + "\n")
    for a, ch in enumerate(ix.alphabet):
        sel = mask & (ix.c_arr == a)
        with open(base + "." + chr(ch), "w") as f:
            for aid, i in zip(adjusted[sel], run_idx[sel]):
                f.write(f"{aid}\t{i}\n")
    _log(f"wrote {base}.all and per-character id files")


def cmd_inspect(args):
    ix = _load_index(args.index)
    print(f"index mode: {ix.mode}")
    print(f"n: {ix.length}")
    print(f"r: {ix.r}")
    print(f"original_r: {ix.original_r}")
    print(f"n/r: {ix.length / ix.r:.4f}")
    if ix.original_r:
        print(f"n/original_r: {ix.length / ix.original_r:.4f}")
    print(f"end_bwt_idx ($): {ix.end_bwt_idx}")
    print(f"alphabet: {''.join(chr(c) for c in ix.alphabet)}")
    for i in range(ix.sigma + 1):
        c = "$" if i == 0 else chr(ix.alphabet[i - 1])
        print(f"{c}\t{i}\t{ix.first_runs[i]}:{ix.first_offsets[i]}\t"
              f"{ix.last_runs[i]}:{ix.last_offsets[i]}")
    for i, cnt in enumerate(ix.counts):
        print(f"counts[{i}]: {cnt}")
    from .constants import MODE_ROW_BYTES

    row_bytes = MODE_ROW_BYTES.get(ix.mode, 8)
    print(f"rlbwt table size (reference row packing): "
          f"{row_bytes * ix.r * 1e-9:.6f} GB")
    if args.output_ids:
        _output_ids(ix, args.index)


def cmd_lf(args):
    """LF micro-benchmarks (move_structure_query.cpp:3-101)."""
    import time as _t

    from .cpu_ref.scalar import ScalarEngine

    ix = _load_index(args.index)
    eng = ScalarEngine(ix)
    n = ix.length
    t0 = _t.time()
    if args.lf_type == "reconstruct":
        idx, off, steps = ix.end_bwt_idx, 0, 0
        while True:
            off, idx, _ = eng.lf_move(off, idx)
            steps += 1
            if idx == ix.end_bwt_idx:
                break
        _log(f"reconstruct: {steps} LF steps")
    elif args.lf_type == "sequential":
        total = 0
        for i in range(ix.r):
            for j in range(int(ix.n_arr[i])):
                _, _, ff = eng.lf_move(j, i)
                total += ff
        _log(f"sequential: {n} LF steps, total ff {total}")
    else:  # random
        rng = np.random.default_rng(args.seed)
        order = rng.permutation(n)[: min(n, args.limit)]
        import numpy as _np

        for p in order:
            i = int(_np.searchsorted(ix.all_p[:-1], p, side="right")) - 1
            eng.lf_move(int(p) - int(ix.all_p[i]), i)
        _log(f"random: {len(order)} LF steps")
    dt = _t.time() - t0
    _log(f"LF {args.lf_type}: {dt:.2f}s")


def cmd_null(args):
    from .build.prepare_ref import iter_fasta
    from .classify import build_nulldb_pml, generate_null_reads
    from .cpu_ref.scalar import ScalarEngine

    ix = _load_index(args.index)
    eng = ScalarEngine(ix)
    records = list(iter_fasta(args.fasta))
    if args.gen_reads:
        # only generate and persist the null reads (--gen-reads,
        # movi_parser.cpp:223)
        path = os.path.join(args.index, "null_reads.fasta")
        rng = np.random.default_rng(args.seed)
        nulls = generate_null_reads(records, rng)
        with open(path, "w") as f:
            for name, s in nulls:
                f.write(f">{name}\n{s.decode()}\n")
        _log(f"wrote {len(nulls)} null reads to {path}")
        return
    both = not args.pml and not args.zml
    if args.pml or both:
        db = build_nulldb_pml(
            ix, lambda s: eng.query_pml(
                s, random_repositioning=ix.thr is None),
            records, seed=args.seed)
        db.save(os.path.join(args.index, "movi.pml.nulldb"))
        _log(f"pml null statistics: percentile={db.percentile_value}")
    if args.zml or both:
        dbz = build_nulldb_pml(ix, eng.query_zml, records, seed=args.seed)
        dbz.save(os.path.join(args.index, "movi.zml.nulldb"))
        _log(f"zml null statistics: percentile={dbz.percentile_value}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="movi-tpu",
                                description="Movi pangenome index queries "
                                            "on JAX")
    sub = p.add_subparsers(dest="command", required=True)

    b = sub.add_parser("build")
    b.add_argument("--fasta", "-f", nargs="+", default=None)
    b.add_argument("--index", "-i", required=True)
    b.add_argument("--type", default="regular-thresholds")
    b.add_argument("--fw", action="store_true",
                   help="do not add reverse complements")
    b.add_argument("--separators", action="store_true")
    b.add_argument("--list", action="store_true")
    b.add_argument("--verify", action="store_true")
    b.add_argument("--keep-ref", action="store_true")
    b.add_argument("--keep", action="store_true",
                   help="keep pipeline intermediates in the index dir "
                        "(ref.fa + reference-format BWT/thresholds), the "
                        "launcher's --keep (movi_launcher.cpp:20-30)")
    b.add_argument("--resume", action="store_true",
                   help="resume from intermediates kept by --keep, "
                        "skipping prepare_ref and the suffix array "
                        "(--skip-prepare/--skip-pfp equivalent)")
    b.add_argument("--skip-null", action="store_true")
    b.add_argument("--bound-ff", type=int, default=None)
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--ftab-k", type=int, default=0)
    b.add_argument("--sa-entries", action="store_true")
    b.add_argument("--sa-sample-rate", type=int, default=100)
    b.add_argument("--color", action="store_true")
    b.add_argument("--compress-colors", action="store_true")
    b.add_argument("--tree-compress-colors", action="store_true")
    b.add_argument("--movi-format", action="store_true",
                   help="also write a reference-compatible index.movi "
                        "(disables NT splitting for size parity)")
    b.add_argument("--bwt-file", default="",
                   help="build from a preprocessed BWT (+ .thr_pos) "
                        "instead of a FASTA (movi build --preprocessed)")
    b.add_argument("--mmap", action="store_true",
                   help="also write a demand-pageable index.mmap/ layout")
    b.add_argument("--legacy-header", action="store_true",
                   help="write a v1-style single-byte index header")
    b.add_argument("--no-header", action="store_true",
                   help="write the index without any header")
    b.add_argument("--fused-cache", action="store_true",
                   help="precompute and store the fused step records "
                        "(skips the per-process rebuild at query time)")
    b.add_argument("--paired-cache", action="store_true",
                   help="also store the paired two-base records (query "
                        "--paired-records skips the compose; ~10x the "
                        "fused cache size)")
    b.add_argument("--checkpoint", type=int, default=20,
                   help="tally id checkpoint spacing for sampled modes "
                        "(reference --checkpoint, default 20)")
    b.set_defaults(func=cmd_build)

    q = sub.add_parser("query")
    q.add_argument("--index", "-i", required=True)
    q.add_argument("--read", "-r", required=True)
    q.add_argument("--pml", action="store_true")
    q.add_argument("--zml", action="store_true")
    q.add_argument("--count", action="store_true")
    q.add_argument("--mem", action="store_true")
    q.add_argument("--kmer", action="store_true")
    q.add_argument("--kmer-count", action="store_true")
    q.add_argument("--k", type=int, default=31)
    q.add_argument("--min-mem-length", type=int, default=0)
    q.add_argument("--ftab-k", type=int, default=0)
    q.add_argument("--classify", action="store_true")
    q.add_argument("--multi-classify", action="store_true")
    q.add_argument("--min-match-len", "--min-len", type=int, default=0)
    q.add_argument("--pvalue-scoring", action="store_true")
    q.add_argument("--lca-tree", default="",
                   help="nodes.dmp for LCA post-processing of multi-class calls")
    q.add_argument("--filter", action="store_true")
    q.add_argument("--invert", action="store_true")
    q.add_argument("--stdout", action="store_true")
    q.add_argument("--reverse", action="store_true")
    q.add_argument("--sa-entries", action="store_true",
                   help="emit SA entries per base (scalar engine path)")
    q.add_argument("--no-jax", action="store_true",
                   help="use the scalar CPU reference engine")
    q.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="run on this JAX platform (cpu/gpu); fails when "
                        "it is not available")
    q.add_argument("--lanes", type=int, default=8192)
    q.add_argument("--paired-records", action="store_true",
                   help="force the paired two-base record engines (one "
                        "gather per two bases for PML/color, one per "
                        "base for count/zml; ~10-20x index memory). "
                        "Default: auto-selected when the table fits "
                        "the device memory budget (engine/select.py)")
    q.add_argument("--no-paired-records", action="store_true",
                   help="force the one-step fused engines (the capacity "
                        "layout)")
    q.add_argument("--bin-width", type=int, default=150)
    q.add_argument("--out-file", "-o", default="")
    q.add_argument("--rpml", action="store_true",
                   help="random repositioning PMLs (RPMLs)")
    q.add_argument("--logs", action="store_true",
                   help="write .costs/.scans/.fastforwards trace files")
    q.add_argument("--profile", default="",
                   help="write a jax.profiler trace to this directory")
    q.add_argument("--mmap", action="store_true",
                   help="memory-map the index row arrays")
    q.add_argument("--no-resplit", action="store_true",
                   help="do not NT re-split a reference-format index at "
                        "load time (keeps the compact fallback engine)")
    q.add_argument("--no-output", action="store_true",
                   help="run the query but write no output files")
    q.add_argument("--early-stop", action="store_true",
                   help="abort unclassified reads early (multi-classify)")
    q.add_argument("--report-all", action="store_true",
                   help="report every document within min-diff-frac / "
                        "min-score-frac of the best")
    q.add_argument("--min-diff-frac", type=float, default=0.05)
    q.add_argument("--min-score-frac", type=float, default=0.0)
    q.add_argument("--report-colors", action="store_true",
                   help="write per-base color ids alongside PMLs")
    q.add_argument("--report-color-ids", action="store_true")
    q.add_argument("--ignore-illegal-chars", type=int, default=0,
                   choices=[0, 1, 2],
                   help="0=off, 1=replace with 'A', 2=replace with a "
                        "random base")
    q.add_argument("--multi-ftab", action="store_true",
                   help="fall back to smaller-k ftabs when the largest "
                        "k-mer lookup fails")
    # accepted for command-line compatibility with the reference; the
    # device engines batch reads over lanes instead of strands/threads
    q.add_argument("--strands", "-s", type=int, default=16,
                   help=argparse.SUPPRESS)
    q.add_argument("--threads", "-t", type=int, default=1,
                   help=argparse.SUPPRESS)
    q.add_argument("--no-prefetch", "-n", action="store_true",
                   help=argparse.SUPPRESS)
    q.set_defaults(func=cmd_query)

    v = sub.add_parser("view")
    v.add_argument("--mls-file", "--bpf", required=True)
    v.add_argument("--classify", action="store_true")
    v.add_argument("--nulldb", default="")
    v.add_argument("--bin-width", type=int, default=150)
    v.add_argument("--small-bpf", action="store_true",
                   help="headerless files: entries are uint16")
    v.add_argument("--large-bpf", action="store_true",
                   help="headerless files: entries are uint64")
    v.set_defaults(func=cmd_view)

    bsa = sub.add_parser("build-SA")
    bsa.add_argument("--index", "-i", required=True)
    bsa.add_argument("--sample-rate", type=int, default=100)
    bsa.set_defaults(func=cmd_build_sa)

    ft = sub.add_parser("ftab")
    ft.add_argument("--index", "-i", required=True)
    ft.add_argument("--ftab-k", type=int, required=True)
    ft.add_argument("--multi-ftab", action="store_true",
                    help="also build the k-2, k-4, ... fallback ftabs")
    ft.set_defaults(func=cmd_ftab)

    co = sub.add_parser("color")
    co.add_argument("--index", "-i", required=True)
    co.add_argument("--full", action="store_true",
                    help="persist per-row doc_pats alongside the doc sets")
    co.add_argument("--compress", "--freq-compress", action="store_true",
                    help="frequency compression: keep the 2^16 most "
                         "frequent doc sets")
    co.add_argument("--tree-compress", action="store_true",
                    help="hierarchical-clustering tree compression")
    co.set_defaults(func=cmd_color)

    rl = sub.add_parser("rlbwt")
    rl.add_argument("--bwt-file", required=True)
    rl.set_defaults(func=cmd_rlbwt)

    cmr = sub.add_parser("color-move-rows")
    cmr.add_argument("--index", "-i", required=True)
    cmr.set_defaults(func=cmd_color_move_rows)

    pr = sub.add_parser("prepare-ref")
    pr.add_argument("--fasta", "-f", nargs="+", required=True)
    pr.add_argument("--output", "-o", required=True)
    pr.add_argument("--fw", action="store_true")
    pr.add_argument("--separators", action="store_true")
    pr.add_argument("--list", action="store_true")
    pr.set_defaults(func=cmd_prepare_ref)

    ins = sub.add_parser("inspect")
    ins.add_argument("--index", "-i", required=True)
    ins.add_argument("--output-ids", action="store_true",
                     help="dump character-adjusted run ids to ids.* files")
    ins.set_defaults(func=cmd_inspect)

    lf = sub.add_parser("LF")
    lf.add_argument("--index", "-i", required=True)
    lf.add_argument("--lf-type", default="sequential",
                    choices=["sequential", "random", "reconstruct"])
    lf.add_argument("--limit", type=int, default=100000)
    lf.add_argument("--seed", type=int, default=0)
    lf.set_defaults(func=cmd_lf)

    nl = sub.add_parser("null")
    nl.add_argument("--index", "-i", required=True)
    nl.add_argument("--fasta", "-f", required=True)
    nl.add_argument("--seed", type=int, default=0)
    nl.add_argument("--pml", action="store_true",
                    help="only (re)build the PML null statistics")
    nl.add_argument("--zml", action="store_true",
                    help="only (re)build the ZML null statistics")
    nl.add_argument("--gen-reads", action="store_true",
                    help="only generate and write the null reads")
    nl.set_defaults(func=cmd_null)

    for sp in (b, q, v, ins, lf, nl, bsa, ft, co, rl, cmr, pr):
        sp.add_argument("--verbose", action="store_true",
                        help=argparse.SUPPRESS)
        sp.add_argument("--debug", "-d", action="store_true",
                        help=argparse.SUPPRESS)
        sp.add_argument("--validate-flags", action="store_true",
                        help="parse and validate the flags, then exit "
                             "(used by launcher-style orchestration)")

    args = p.parse_args(argv)
    if getattr(args, "validate_flags", False):
        print("flags OK")
        return
    # the platform and the compile cache are applied once, before any JAX
    # use; JAX reads JAX_PLATFORMS itself, --platform overrides it
    from .runtime import apply_platform, enable_compile_cache

    if getattr(args, "platform", None):
        apply_platform(args.platform)
    enable_compile_cache()
    if args.filter if hasattr(args, "filter") else False:
        args.classify = True
    from .commons import error, timing

    try:
        # TIMING section around every subcommand (commons.hpp:31-44;
        # the reference times load/query in movi.cpp:268,387-389)
        with timing(args.command):
            args.func(args)
    except (AssertionError, ValueError, FileNotFoundError) as e:
        # formatted fatal errors like the reference's catch in main
        # (movi.cpp:744-747)
        error(str(e))
        raise SystemExit(1)


if __name__ == "__main__":
    main()
