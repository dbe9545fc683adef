"""chip_smoke.py at a tiny size on the CPU: each phase runs through the
CLI in-process and is compared with the cpu_ref oracle; the script
itself refuses to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

PHASES = {ph[0]: ph for ph in cs.PHASES}


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke"))
    cs.watch_compiles()
    data = cs.make_data(work, seed=3, base_len=20000, haplotypes=4,
                        n_reads=400, n_tick=200, n_sample=50)
    idx = cs.build_index(work, data)
    return work, data, idx


def _run(smoke, names):
    work, data, idx = smoke
    return {n: cs.query_phase(*PHASES[n], data=data, idx=idx, work=work,
                              card="cpu test")
            for n in names}


@pytest.mark.parametrize("paired,one_step", cs.SAME_OUTPUT)
def test_paired_equals_one_step(smoke, paired, one_step, capsys):
    outs = _run(smoke, [paired, one_step])
    with open(outs[paired], "rb") as a, open(outs[one_step], "rb") as b:
        assert a.read() == b.read()
    said = capsys.readouterr().out
    assert said.count("bit-exact with cpu_ref on 50 sampled reads") == 2
    assert "engine='paired" in said


@pytest.mark.parametrize("phase", ["pml classify", "mem", "kmer",
                                   "kmer-count", "sa-entries",
                                   "multi-classify"])
def test_phase_matches_oracle(smoke, phase, capsys):
    _run(smoke, [phase])
    said = capsys.readouterr().out
    assert f"phase {phase}: bit-exact with cpu_ref" in said


def test_phase_detects_a_mismatch(smoke, monkeypatch):
    """A device output that differs from the oracle fails the phase."""
    real = cs.read_output

    def corrupt(kind, path, names):
        got = real(kind, path, names)
        if path.endswith(".device"):
            first = sorted(got)[0]
            got[first] = got[first][:-1]
        return got

    monkeypatch.setattr(cs, "read_output", corrupt)
    with pytest.raises(SystemExit, match="differ from the oracle"):
        _run(smoke, ["count"])


def test_compile_seconds_is_a_union(monkeypatch):
    # nested (10..12 inside 9..13) and overlapping intervals
    monkeypatch.setattr(cs, "_COMPILES", [(12.0, 2.0), (13.0, 4.0),
                                          (16.0, 1.0), (30.0, 5.0)])
    assert cs.compile_seconds(10.0, 20.0) == pytest.approx(4.0)


def test_four_card_path_on_virtual_devices():
    assert len(jax.devices()) >= 4
    cs.four_card_check(jax.devices()[:4], seed=5, base_len=5000,
                       haplotypes=2, lanes=64, card="cpu test")


def test_main_without_gpu_exits_nonzero():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "needs a GPU" in r.stderr


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True)
    assert r.returncode != 0
    assert r.stdout == ""
