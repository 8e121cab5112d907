"""Layer: the ICI fabric and its ops.  Device operations (kernels,
memcpys and memsets) in the traced window, over the calls completed in
it.  Counted from the trace, so a kernel that replaces another is
counted whatever its name."""


def read(ctx):
    tl = ctx.timeline
    if tl is None or ctx.completed == 0:
        return None
    n = tl.op_count()
    return n / ctx.completed if n else None
