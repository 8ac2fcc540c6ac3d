"""Coding/non-coding neural filter (reference: src/assembler/
filternoncoding.cpp:26-181, weights from the bundled kerasify model).

57-dim feature vector per protein: [length, 20 Laplace-smoothed amino-acid
frequencies (matrix alphabet order, denom = totalAA + 20), 36 reduced-7
dipeptide frequencies (little-endian index, X excluded, denom = total + 36)],
fed to a 57->32->64->1 MLP (relu, relu, sigmoid). Sequences scoring <=
threshold are replaced with empty records.

The features are computed on the host (numpy, float64 then float32, as the
reference); the MLP runs on the device in float32 with TF32 off, since a
reduced-precision product could move a borderline score across the
threshold.
"""
import numpy as np
import torch
from torch import nn

from .. import constants
from ..data import seqdb


def features(db):
    """Feature matrix float32[N, 57] in reference order."""
    blosum = constants.blosum62()
    red7 = constants.reduced(7)
    a20 = blosum.alphabet_size - 1          # 20
    a7 = red7.alphabet_size                 # 7
    r6 = a7 - 1                             # 6
    n = db.size
    lens = db.seq_lens().astype(np.int64)
    feats = np.zeros((n, 1 + a20 + r6 * r6), dtype=np.float32)
    feats[:, 0] = lens
    # every residue, in id order, with the id it belongs to
    seg = np.repeat(np.arange(n), lens)
    starts = np.cumsum(lens) - lens
    res = np.asarray(db.data)[np.repeat(db.offsets.astype(np.int64) - starts,
                                        lens) + np.arange(len(seg))]
    num = blosum.aa2num[res].astype(np.int64)
    aa = num < a20
    counts = np.bincount(seg[aa] * a20 + num[aa], minlength=n * a20) \
        .reshape(n, a20).astype(np.float64) + 1.0
    total = np.bincount(seg[aa], minlength=n).astype(np.float64)
    feats[:, 1:1 + a20] = (counts / (total[:, None] + a20)).astype(np.float32)
    # dipeptides on reduced-7 within one sequence; skip any pair with X
    rnum = red7.aa2num[res].astype(np.int64)
    a, b = rnum[:-1], rnum[1:]
    ok = (seg[:-1] == seg[1:]) & (a != r6) & (b != r6)
    di = np.bincount(seg[:-1][ok] * a7 * a7 + a[ok] + b[ok] * a7,
                     minlength=n * a7 * a7).reshape(n, a7 * a7) \
        .astype(np.float64) + 1.0
    total_di = np.bincount(seg[:-1][ok], minlength=n).astype(np.float64)
    # indices whose little-endian digits are both non-X, ascending
    # (filternoncoding.cpp:111-122)
    sel = [raw for raw in range(a7 * a7) if raw % a7 != r6 and raw // a7 != r6]
    feats[:, 1 + a20:] = (di[:, sel] / (total_di[:, None] + r6 * r6)) \
        .astype(np.float32)
    return feats


class CodingFilter(nn.Module):
    """The 57->32->64->1 MLP: x @ w + b per layer, then relu or sigmoid."""

    def __init__(self, shapes, acts):
        super().__init__()
        self.acts = list(acts)
        self.weights = nn.ParameterList(
            nn.Parameter(torch.empty(i, o), requires_grad=False)
            for i, o in shapes)
        self.biases = nn.ParameterList(
            nn.Parameter(torch.empty(o), requires_grad=False)
            for _, o in shapes)

    @classmethod
    def from_numpy(cls, layers):
        """From the [(w float32[in, out], b float32[out], act), ...] list of
        constants.coding_filter_weights()."""
        model = cls([w.shape for w, _, _ in layers], [a for _, _, a in layers])
        with torch.no_grad():
            for (w, b, _), pw, pb in zip(layers, model.weights, model.biases):
                pw.copy_(torch.from_numpy(np.asarray(w, dtype=np.float32)))
                pb.copy_(torch.from_numpy(np.asarray(b, dtype=np.float32)))
        return model

    def forward(self, x):
        for w, b, act in zip(self.weights, self.biases, self.acts):
            x = x @ w + b
            if act == "relu":
                x = torch.clamp(x, min=0.0)
            elif act == "sigmoid":
                x = 1.0 / (1.0 + torch.exp(-x))
        return x[:, 0]


def predict(feats, device):
    """Coding scores float32[N] of a feature matrix, computed on `device`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = CodingFilter.from_numpy(constants.coding_filter_weights()) \
        .to(device)
    with torch.no_grad():
        return model(torch.from_numpy(feats).to(device)).cpu().numpy()


def filter_noncoding(db, device, threshold=0.2):
    """Keep sequences with score > threshold; others become empty records."""
    scores = predict(features(db), device)
    writer = seqdb.DBWriter(db.dbtype)
    for i in range(db.size):
        key = int(db.keys[i])
        if scores[i] > threshold:
            writer.write(key, db.get_seq_bytes(i))
        else:
            writer.write(key, b"", add_newline=True)
    return writer.finish()
