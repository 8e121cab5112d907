"""task_stacks — dump every runtime thread/task stack.

Analog of the reference's tools/gdb_bthread_stack.py (a gdb plugin that
walks bthread stacks of a live process): in this runtime tasks run on
worker threads, so ``sys._current_frames`` reaches every live stack
without gdb. Usable three ways:

  * library: ``dump_stacks() -> str``
  * builtin service: GET /bthreads on any server
  * CLI: ``python -m incubator_brpc_tpu_torch.tools.task_stacks <pid>``
    (sends SIGUSR1 to a cooperating process — servers install the
    handler at start — which writes the dump to its stderr).
"""

from __future__ import annotations

import signal
import sys
import threading
import traceback


def dump_stacks() -> str:
    """All thread stacks, runtime workers annotated."""
    frames = sys._current_frames()
    by_id = {t.ident: t for t in threading.enumerate()}
    out = []
    for tid, frame in sorted(frames.items()):
        t = by_id.get(tid)
        name = t.name if t else "?"
        daemon = " daemon" if (t and t.daemon) else ""
        kind = ""
        if name.startswith("tpubrpc-worker"):
            kind = " [runtime worker]"
        elif name.startswith("tpubrpc"):
            kind = " [runtime]"
        out.append(f"--- thread {tid} {name}{daemon}{kind}")
        out.extend(
            line.rstrip() for line in traceback.format_stack(frame)
        )
    return "\n".join(out)


def install_sigusr1_handler():
    """Make SIGUSR1 print the dump to stderr (live-process debugging,
    the gdb-plugin use case without gdb)."""

    def _handler(signum, frame):
        sys.stderr.write(dump_stacks() + "\n")
        sys.stderr.flush()

    try:
        signal.signal(signal.SIGUSR1, _handler)
        return True
    except (ValueError, OSError):  # not the main thread / unsupported
        return False


def main(argv=None):
    import os

    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print(dump_stacks())
        return
    pid = int(args[0])
    os.kill(pid, signal.SIGUSR1)
    print(f"sent SIGUSR1 to {pid}; dump goes to its stderr")


if __name__ == "__main__":
    main()
