"""The matcher (ops.backend.match_kmers: host part, device_kmer, K1):
mean milliseconds a step of the benchmark's span around it, the device
synchronised at both ends."""


def read(rec):
    s = rec.spans.get("kmermatch")
    return 1e3 * sum(s) / len(s) if s else None
