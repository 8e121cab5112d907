"""Layer: the device.  100 x (1 - union of the device's kernel, memcpy and
memset intervals / the traced window)."""


def read(ctx):
    tl = ctx.timeline
    if tl is None or tl.window_ns <= 0 or tl.busy_ns <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_ns / tl.window_ns)
