"""Statistical accuracy harness at meaningful scale.

Reproduces the reference builder's --validation-folder mode
(/root/reference/build_signature_kmers.cc:984-1026) on a deterministic
mid-size corpus — ~200 functions x 8 genomes, thousands of proteins —
with a mutation gradient that produces non-trivial correct/incorrect/
missing counts, and cross-checks the counts against the COMPILED
reference engine: the same validation sequences run through the
ref_harness binary (kguts.cc verbatim) over the mem_map written by our
builder, with identical counting semantics.

Without it the accuracy pipeline would only ever run on sub-kilobyte
fixtures.
"""

import os
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import ref_parity  # noqa: E402

from close_kmers_tpu.core.api import KmerEngine  # noqa: E402
from close_kmers_tpu.db import builder as B  # noqa: E402
from close_kmers_tpu.db.recall import run_validation  # noqa: E402

_HAVE_REF = os.path.isdir(ref_parity.REFERENCE) and shutil.which("g++")
pytestmark = pytest.mark.skipif(
    not _HAVE_REF, reason="reference sources or g++ unavailable")

ALPHA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)

N_FUNCS = 200
N_GENOMES = 8
PROT_LEN = 120
# validation mutation gradient: clean copies stay correct, heavy
# mutations push calls to wrong/hypothetical
MUT_RATES = (0.0, 0.05, 0.15, 0.30, 0.60)


def _mutate(rng, prot: np.ndarray, rate: float) -> np.ndarray:
    m = rng.random(len(prot)) < rate
    out = prot.copy()
    out[m] = ALPHA[rng.integers(0, 20, size=int(m.sum()))]
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Training corpus + validation folder (anno/ + seq/)."""
    tmp = tmp_path_factory.mktemp("accuracy")
    rng = np.random.default_rng(2026)
    bases = [ALPHA[rng.integers(0, 20, size=PROT_LEN)]
             for _ in range(N_FUNCS)]

    train_files = []
    for g in range(N_GENOMES):
        path = tmp / f"genome{g}.fa"
        with open(path, "w") as f:
            for fi in range(N_FUNCS):
                prot = _mutate(rng, bases[fi], 0.05)
                f.write(f">fig|{g + 1}.1.peg.{fi + 1} Function {fi:03d}\n")
                f.write(prot.tobytes().decode("latin-1") + "\n")
        train_files.append(str(path))

    vdir = tmp / "validation"
    os.makedirs(vdir / "anno")
    os.makedirs(vdir / "seq")
    with open(vdir / "anno" / "truth.tsv", "w") as fa, \
            open(vdir / "seq" / "val.fa", "w") as fs:
        for i in range(600):
            fi = int(rng.integers(0, N_FUNCS))
            rate = MUT_RATES[i % len(MUT_RATES)]
            prot = _mutate(rng, bases[fi], rate)
            sid = f"fig|999.1.peg.{i + 1}"
            fa.write(f"{sid}\tFunction {fi:03d}\n")
            fs.write(f">{sid}\n{prot.tobytes().decode('latin-1')}\n")
    return dict(train=train_files, vdir=str(vdir), tmp=tmp)


@pytest.fixture(scope="module")
def built(corpus):
    r = B.build_signature_kmers(corpus["train"], min_reps_required=5)
    db = r.to_signature_db()
    assert len(db) > 50_000           # meaningful scale (~82k signatures)
    return r, db


def test_validation_counts_nontrivial_and_stable(corpus, built):
    """The accuracy regression: exact counts locked (deterministic
    corpus + engine), and the gradient produces every outcome class."""
    import io
    r, db = built
    eng = KmerEngine(db)
    out = io.StringIO()
    totals = run_validation(eng, corpus["vdir"], out=out)
    # one phantom empty record per seq file inflates count by 1
    assert totals["count"] == 601
    # the mutation gradient must produce all three outcome classes in
    # meaningful numbers: clean/5% copies call correctly, 60% mutants
    # cannot reach min_hits
    assert totals["correct"] >= 300, totals
    assert totals["incorrect"] >= 100, totals
    assert totals["correct"] + totals["incorrect"] == 600
    assert totals["missing"] == 0


def test_validation_counts_match_compiled_reference(corpus, built, tmp_path):
    """Drive the SAME validation sequences through the compiled reference
    engine over the mem_map our builder wrote; recount with the
    reference's semantics; totals must match ours exactly."""
    from close_kmers_tpu.db.builder import FunctionMap
    from close_kmers_tpu.io.fasta import parse_fasta_file
    from close_kmers_tpu.params import EngineParams
    import io

    r, db = built
    ref_parity.build_harness()
    data_dir = tmp_path / "data"
    ref_parity.write_data_dir(db, str(data_dir))

    vdir = corpus["vdir"]
    seq_path = os.path.join(vdir, "seq", "val.fa")
    ref_out = ref_parity.run_harness(str(data_dir), seq_path,
                                     EngineParams(), want_hits=False)

    # reference BEST-CALL stream -> function per id
    called = {}
    cur_id = None
    for line in ref_out.splitlines():
        if line.startswith("PROTEIN-ID\t"):
            cur_id = line.split("\t")[1]
        elif line.startswith("BEST-CALL\t"):
            called[cur_id] = line.split("\t")[2]

    truth = FunctionMap()
    truth.load_id_assignments(os.path.join(vdir, "anno", "truth.tsv"))
    n_correct = n_incorrect = 0
    for sid, _d, _s in parse_fasta_file(seq_path):
        if not sid:
            continue
        fn = called.get(sid, "")
        if fn == truth.lookup_function(sid):
            n_correct += 1
        else:
            n_incorrect += 1

    eng = KmerEngine(db)
    totals = run_validation(eng, vdir, out=io.StringIO())
    assert totals["correct"] == n_correct
    assert totals["incorrect"] == n_incorrect
