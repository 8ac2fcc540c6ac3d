"""The sharded matcher's exchanges: megabytes (10^6 bytes) rank 0 sends a
step, the table and pair exchanges and its part of the hits' all-gather,
as parallel/mesh.ExchangeStats counts them (match_kmers' stats); the
entry records them a step under "exchange_bytes", by exchange."""


def read(rec):
    steps = rec.spans.get("exchange_bytes")
    if not steps:
        return None
    return sum(sum(s.values()) for s in steps) / 1e6 / len(steps)
