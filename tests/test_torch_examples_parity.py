"""The port's examples against the JAX package's, on the CPU.

Each pair runs the JAX example and its port (``--device cpu``) as
children, and holds the lines that carry values to each other exactly:
byte counts, success counts, token counts.  What depends on timing or
on the host is masked, field by field (MASKS below names each one).
Both children also count the calls their package's fabric makes into
its transmit entry points (the functions that reach a copy+checksum
kernel; ``LAUNCH`` of test_torch_examples.py): the port must reach them
as often as the JAX package does.

A device example run with neither a card nor ``--device`` must raise."""

import functools
import json
import pathlib
import re
import subprocess
import sys

import pytest
from test_torch_examples import LAUNCH

ROOT = pathlib.Path(__file__).resolve().parents[1]

# every field masked before two lines are compared, per example
MASKS = {
    "ici_echo.py": [],
    "batched_ps.py": [
        # how the batcher's windows fell: executions, largest batch, occupancy
        (r"coalesced into \d+ fused", "coalesced into <executions> fused"),
        (r"max batch \d+", "max batch <max_batch_seen>"),
        (r"occupancy [0-9.]+", "occupancy <occupancy>"),
    ],
    "replicated_ps.py": [
        # the leaders' ephemeral TCP ports
        (r"127\.0\.0\.1:\d+", "127.0.0.1:<port>"),
    ],
    "streaming_generate.py": [
        # the decode loop's step count, the joins and the widest step
        # depend on when each client's request lands between steps
        (r"'steps': \d+", "'steps': <steps>"),
        (r"'mid_stream_joins': \d+", "'mid_stream_joins': <joins>"),
        (r"'max_fused': \d+", "'max_fused': <max_fused>"),
    ],
}

# '  [client-i] n tokens so far': how the tokens were grouped into
# deliveries is timing (and the handler threads' prints interleave), so
# each client's final count is compared instead
_PROGRESS = re.compile(r"\s*\[(client-\d+)\] (\d+) tokens so far")


@functools.lru_cache(maxsize=None)
def run(package, script, *args):
    """(value lines, final token count per client, transmit calls) of
    one example's child, run once per arguments in this module."""
    folder = "examples_torch" if package.endswith("_torch") else "examples"
    proc = subprocess.run(
        [sys.executable, "-c", LAUNCH, package, str(ROOT / folder / script), *args],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert proc.returncode == 0, (package, proc.stderr[-2000:])
    finals = {}
    for client, n in _PROGRESS.findall(proc.stdout):
        finals[client] = max(finals.get(client, 0), int(n))
    lines, transmits = [], None
    for line in _PROGRESS.sub("", proc.stdout).splitlines():
        if not line or line.startswith("FOREIGN AT EXIT"):
            continue  # the JAX child loads jax: the examples file checks the port's
        if line.startswith("TRANSMITS "):
            transmits = json.loads(line[len("TRANSMITS "):])
            continue
        for pattern, mask in MASKS[script]:
            line = re.sub(pattern, mask, line)
        lines.append(line)
    assert transmits is not None, proc.stdout[-2000:]
    return lines, finals, transmits


@pytest.mark.parametrize("script", sorted(MASKS))
def test_port_example_prints_the_jax_examples_values(script):
    jax_lines, jax_finals, jax_transmits = run("incubator_brpc_tpu", script)
    lines, finals, transmits = run("incubator_brpc_tpu_torch", script,
                                   "--device", "cpu")
    assert lines and lines == jax_lines
    assert finals == jax_finals
    assert transmits == jax_transmits


def test_streaming_generate_final_token_counts_are_the_requested_lengths():
    _, finals, _ = run("incubator_brpc_tpu_torch", "streaming_generate.py",
                       "--device", "cpu")
    assert finals == {"client-0": 24, "client-1": 12, "client-2": 18, "client-3": 6}


# each device example, and the line it prints only after its device work
DEVICE_EXAMPLES = {
    "ici_echo.py": "device-resident",
    "batched_ps.py": "batched gets coalesced into",
    "sharded_ps.py": "sharded forward merged",
    "replicated_ps.py": "acknowledged writes still readable",
    "streaming_generate.py": "continuously-batched streams",
    "disagg_serving.py": "migrated live with prefill reused",
}


@pytest.mark.parametrize("script", sorted(DEVICE_EXAMPLES))
def test_device_example_raises_without_a_card(script):
    """No card and no --device: the example stops at its first device,
    as device_for_chip does, and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / script)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert proc.returncode != 0
    assert "no CUDA device for ici chip" in proc.stderr, proc.stderr[-2000:]
    assert DEVICE_EXAMPLES[script] not in proc.stdout
