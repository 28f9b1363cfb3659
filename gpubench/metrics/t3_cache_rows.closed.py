"""t3_cache_rows.closed: the largest capacity, in positions, that the batched
T3 decoder's KV cache held for a slice of the window: the ``cache_rows`` of
its ``t3.slice`` spans. None where they carry none (a program whose cache
is fixed at max_seq_len)."""
from gpubench.spans import named


def read(ctx):
    rows = [e.attrs["cache_rows"] for e in named(ctx, "t3.slice") if "cache_rows" in e.attrs]
    return float(max(rows)) if rows else None
