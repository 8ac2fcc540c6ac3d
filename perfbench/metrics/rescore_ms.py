"""The rescore (ops.backend.rescore_diagonal_torch: host part and K2):
mean milliseconds a step of the benchmark's span around it, the device
synchronised at both ends."""


def read(rec):
    s = rec.spans.get("rescore")
    return 1e3 * sum(s) / len(s) if s else None
