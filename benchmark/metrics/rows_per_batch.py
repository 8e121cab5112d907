"""Layer: micro-batcher.  Rows over batches that ``PsService.Forward``'s
batcher flushed in the window (its ``rows`` and ``batches`` counters)."""


def read(ctx):
    rows = ctx.counters.get("forward_rows")
    batches = ctx.counters.get("forward_batches")
    if not batches:
        return None
    return rows / batches
