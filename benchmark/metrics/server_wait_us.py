"""Layer: server dispatch.  Mean over the window's server spans of
``callback_start_us - received_us``: from the frame's arrival at the
server port to the handler's start, the batcher's wait included (a
batched row's callback starts when its batch is flushed)."""


def read(ctx):
    spans = ctx.server_spans
    if not spans:
        return None
    waits = [cb - rx for _, _, rx, cb in spans if rx and cb and cb >= rx]
    if not waits:
        return None
    return sum(waits) / len(waits)
