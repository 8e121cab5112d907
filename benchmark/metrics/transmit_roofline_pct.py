"""Layer: the transmit kernel.  The least time the HBM needs for the
bytes the echoes had to move, over the device's busy time in the traced
window, in percent: each call is two hops, and each hop reads the
payload once and writes it once, whatever kernel does it."""

from math import prod

from benchmark.harness import peaks

_ELEMENT_BYTES = {"float32": 4, "float16": 2, "bfloat16": 2, "uint8": 1}


def transmit_bytes(calls: int, payload_bytes: int) -> int:
    return calls * 2 * 2 * payload_bytes


def read(ctx):
    payload = ctx.cell.traffic.get("payload")
    tl = ctx.timeline
    if payload is None or tl is None or tl.busy_ns <= 0 or ctx.completed == 0:
        return None
    nbytes = prod(payload["shape"]) * _ELEMENT_BYTES[payload["dtype"]]
    least_s = transmit_bytes(ctx.completed, nbytes) / peaks.HBM_BYTES_PER_S
    return 100.0 * least_s / (tl.busy_ns / 1e9)
