"""Layer: the Forward product.  The least time the card needs for the
products the window's batches asked for, over the device's busy time in
the traced window, in percent.

A product of n served rows (the padding not counted) against the (d, d)
float32 W (d the configuration's ``hidden_size``) needs 2 n d^2 operations, at the float32 rate outside the
tensor cores (TF32 stays off), and (4 d^2 + 8 n d) bytes: W read once,
x read and y written once; its least time is the larger of the two.
The batcher counts rows and batches, not each batch's size, so the sum
over products is taken as the larger of the summed operation time and
the summed byte time: exact while every product lies on one side of the
ridge (for d = 6144 all n up to 40 are bound by W's bytes), and never
above the true least time otherwise.
"""

from benchmark.harness import peaks


def least_seconds(rows: int, batches: int, d: int) -> float:
    flops_s = 2.0 * rows * d * d / peaks.FP32_FLOPS
    bytes_s = (4.0 * d * d * batches + 8.0 * rows * d) / peaks.HBM_BYTES_PER_S
    return max(flops_s, bytes_s)


def read(ctx):
    rows = ctx.counters.get("forward_rows")
    batches = ctx.counters.get("forward_batches")
    d = ctx.cell.config.get("hidden_size")
    tl = ctx.timeline
    if not batches or d is None or tl is None or tl.busy_ns <= 0:
        return None
    return 100.0 * least_seconds(rows, batches, int(d)) / (tl.busy_ns / 1e9)
