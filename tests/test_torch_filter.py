"""PyTorch port: the coding/non-coding filter. The features equal the JAX
package's exactly; CodingFilter (the 57->32->64->1 MLP as an nn.Module)
holds the JAX package's predict to ATOL, and every keep/drop decision
farther than ATOL from the threshold agrees; the filtered DB is equal.

ATOL is float32 summation order: the length feature puts the first
layer's pre-activations near 10^3, where one float32 ulp is 6e-5, and the
two frameworks sum the 57 products in different orders. Measured on these
inputs, the scores differ by up to 2.4e-6; the JAX package's own float32
result is as far from a float64 evaluation (1.6e-6 to 2.4e-6)."""
import os

import numpy as np
import pytest
import torch

from plass_tpu import constants
from plass_tpu.assembler import filternoncoding as jf
from plass_tpu.data import seqdb
from plass_tpu.data.createdb import merge_reads
from plass_tpu.ops import orf as orf_mod
from plass_tpu.ops import translate as tr
from plass_tpu_torch import constants as port_constants
from plass_tpu_torch.assembler import filternoncoding as pf
from plass_tpu_torch.data.seqdb import SeqDB as PortSeqDB

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
READS = [os.path.join(FIX, "mini_1.fastq.gz"),
         os.path.join(FIX, "mini_2.fastq.gz")]
ATOL = 5e-6


def _proteins():
    """The fixture's translated ORFs plus edge cases: empty, one residue,
    all-X, lower case, '*' ends."""
    reads, _ = merge_reads(READS)
    odb, ohdb = orf_mod.extract_orfs(reads, min_length=20, max_length=32734,
                                     max_gaps=0, start_mode=0)
    aa = tr.translate_nucs(odb, ohdb, 1, add_orf_stop=True)
    recs = [aa.get_seq_bytes(i) for i in range(aa.size)]
    recs += [b"", b"M", b"XXXXXXXX", b"mkvlaagrst", b"*MKVLAAG*"]
    return seqdb.SeqDB.from_records(recs, dbtype=seqdb.AMINO_ACIDS)


def _port(db):
    return PortSeqDB(db.data, db.keys, db.offsets, db.lengths, db.dbtype)


def test_features_equal():
    db = _proteins()
    np.testing.assert_array_equal(pf.features(_port(db)), jf.features(db))


def test_weights_are_the_reference_weights():
    for (w, b, a), (pw, pb, pa) in zip(constants.coding_filter_weights(),
                                       port_constants.coding_filter_weights()):
        np.testing.assert_array_equal(w, pw)
        np.testing.assert_array_equal(b, pb)
        assert a == pa
    model = pf.CodingFilter.from_numpy(constants.coding_filter_weights())
    assert [tuple(w.shape) for w in model.weights] == [(57, 32), (32, 64),
                                                       (64, 1)]


@pytest.mark.parametrize("which", ["fixture", "random"])
def test_coding_filter_matches_predict(which):
    if which == "fixture":
        feats = jf.features(_proteins())
    else:
        rng = np.random.default_rng(9)
        feats = rng.random((500, 57)).astype(np.float32)
        feats[:, 0] = rng.integers(1, 3000, 500)
    model = pf.CodingFilter.from_numpy(constants.coding_filter_weights())
    with torch.no_grad():
        got = model(torch.from_numpy(feats)).numpy()
    want = jf.predict(feats)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(pf.predict(feats, torch.device("cpu")), got)
    clear = np.abs(want - 0.2) > ATOL
    np.testing.assert_array_equal((got > 0.2)[clear], (want > 0.2)[clear])


def test_filter_noncoding_equal():
    db = _proteins()
    got = pf.filter_noncoding(_port(db), torch.device("cpu"), 0.2)
    want = jf.filter_noncoding(db, 0.2)
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(want.data))
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert 0 < int((got.lengths > 2).sum()) < got.size  # kept and dropped
