"""The device step of an assembly iteration, as `plass assemble` (iteration
1 on) and `penguin nuclassemble` run it: the port's k-mer matcher, then
its END_TO_END rescore of the hits to flat records.

    hits = plass_tpu_torch.ops.backend.match_kmers(db, k, device, "single",
                                                   **matcher_kw)
    recs = plass_tpu_torch.ops.backend.rescore_diagonal_torch(
        db, hits, rescore_params, evaluer, return_flat=True)

`prepare(cfg, db, device)` builds the program's inputs (its SeqDB of the
generator's arrays, its parameters) and returns `step(spans=None)`, one
call of which runs the step and waits for the device. With `spans`, a
dict of lists, each layer's seconds are appended under its name, the
device synchronised at both ends. The step returns what is compared with
the reference: the hits (rep, tgt, score, diag) and the records, as host
arrays; the program's device tensors are dropped with the step.
"""
import contextlib
import time

LAYERS = ("kmermatch", "rescore")


def prepare(cfg, db, device):
    import torch
    from plass_tpu_torch.data import seqdb
    from plass_tpu_torch.ops import backend
    from plass_tpu_torch.ops.evalue import EvalueComputer
    from plass_tpu_torch.ops.rescore import RescoreParams

    nucleotide = cfg["dbtype"] == "nucleotide"
    sdb = seqdb.SeqDB(db.data, db.keys, db.offsets, db.lengths,
                      seqdb.NUCLEOTIDES if nucleotide else seqdb.AMINO_ACIDS)
    matcher_kw = dict(
        kmers_per_sequence=cfg["kmers_per_sequence"],
        kmers_per_sequence_scale=cfg["kmers_per_sequence_scale"],
        hash_shift=cfg["hash_shift"],
        ignore_multi_kmer=cfg["ignore_multi_kmer"],
        include_only_extendable=cfg["include_only_extendable"],
        cov_thr=cfg["cov_thr"], cov_mode=cfg["cov_mode"])
    params = RescoreParams(rescore_mode=cfg["rescore_mode"],
                           seq_id_thr=cfg["min_seq_id"],
                           cov_thr=cfg["cov_thr"], cov_mode=cfg["cov_mode"],
                           eval_thr=cfg["eval_thr"],
                           aln_len_thr=cfg["min_aln_len"],
                           seq_id_mode=cfg["seq_id_mode"])
    evaluer = EvalueComputer.for_matrix(cfg["evalue_params"],
                                        sdb.total_residues())
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def span(name, spans):
        """The layer's seconds, the device synchronised at both ends, and
        its name on the profiler's timeline; nothing without spans."""
        if spans is None:
            return contextlib.nullcontext()
        return _Span(name, spans, sync)

    def step(spans=None):
        with span("kmermatch", spans):
            hits = backend.match_kmers(
                sdb, cfg["k"], device, "single",
                split_memory_limit=cfg["split_memory_limit"], **matcher_kw)
        with span("rescore", spans):
            recs = backend.rescore_diagonal_torch(sdb, hits, params, evaluer,
                                                  return_flat=True)
        sync()
        qk, tk, score, diag = hits
        s = hits.hit_slots
        out = ((qk[s], tk[s], score[s], diag[s]), recs)
        del hits
        return out

    return step


class _Span:
    def __init__(self, name, spans, sync):
        import torch
        self.name, self.spans, self.sync = name, spans, sync
        self.mark = torch.profiler.record_function(name)

    def __enter__(self):
        self.sync()
        self.mark.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.sync()
        self.spans[self.name].append(time.perf_counter() - self.t0)
        self.mark.__exit__(*exc)
