import os
import sys

# Tests run on the CPU (JAX_PLATFORMS=cpu); multi-device sharding tests
# run on a virtual 8-device CPU mesh.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# one persistent compile cache, shared with every CLI subprocess the
# tests spawn (movi_tpu/runtime.py)
from movi_tpu.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REF_DATA = "/root/reference/tests_data"


def _ref_data_available():
    return os.path.exists(os.path.join(REF_DATA, "ref.fasta"))


requires_ref_data = pytest.mark.skipif(
    not _ref_data_available(), reason="reference tests_data not mounted"
)


def _seeded_reference(tmp_path_factory) -> str:
    """Stand-in for the reference's ref.fasta when its test data is not
    mounted: a small seeded pangenome (movi_tpu/synth.py)."""
    from movi_tpu import synth

    path = str(tmp_path_factory.getbasetemp() / "seeded_ref.fasta")
    if not os.path.exists(path):
        haps = synth.pangenome(seed=7, base_len=20000, haplotypes=3)
        synth.write_fasta(path, [(f"hap{i}", h) for i, h in enumerate(haps)])
    return path


@pytest.fixture(scope="session")
def reference_fasta(tmp_path_factory):
    if _ref_data_available():
        return os.path.join(REF_DATA, "ref.fasta")
    return _seeded_reference(tmp_path_factory)


@pytest.fixture(scope="session")
def bwt_runs(reference_fasta):
    from movi_tpu.build.prepare_ref import prepare_ref
    from movi_tpu.build.suffix import build_bwt_runs

    return build_bwt_runs(prepare_ref(reference_fasta).text)


@pytest.fixture(scope="session")
def index_regular_thr(bwt_runs):
    from movi_tpu.index.structure import build_move_index

    return build_move_index(bwt_runs, "regular-thresholds")


@pytest.fixture(scope="session")
def sample_reads(reference_fasta):
    from movi_tpu.io.fastx import iter_fastx

    if _ref_data_available():
        return list(iter_fastx(os.path.join(REF_DATA, "sample.fastq")))
    from movi_tpu import synth
    from movi_tpu.build.prepare_ref import iter_fasta

    haps = [np.frombuffer(s, np.uint8) for _, s in iter_fasta(reference_fasta)]
    reads = synth.sample_reads(haps, 40, 150, seed=8)
    return [(f"read{i}", r.tobytes()) for i, r in enumerate(reads)]


@pytest.fixture(scope="session")
def golden_pmls_sorted():
    with open(os.path.join(REF_DATA, "sample.fastq.pmls.sorted")) as f:
        return f.read()
