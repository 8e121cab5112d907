"""Framework logging (analog of butil/logging.{h,cc}).

Chromium-style leveled logging with pluggable sink (reference LogSink,
logging.h). Thin over stdlib logging so user processes can integrate,
but with the reference's API shape: LOG(INFO) << ... becomes
log_info(...); CHECK macros become check()/check_eq().
"""

from __future__ import annotations

import logging as _pylog
import sys

_logger = _pylog.getLogger("incubator_brpc_tpu_torch")
if not _logger.handlers:
    _h = _pylog.StreamHandler(sys.stderr)
    _h.setFormatter(
        _pylog.Formatter("%(levelname).1s%(asctime)s %(filename)s:%(lineno)d] %(message)s")
    )
    _logger.addHandler(_h)
    _logger.setLevel(_pylog.WARNING)
    _logger.propagate = False

_sink = None  # custom LogSink; returning True swallows the record


def set_log_sink(sink):
    """Install a custom sink: callable(level:str, msg:str) -> bool.
    Analog of logging::SetLogSink (reference logging.h)."""
    global _sink
    old, _sink = _sink, sink
    return old


def set_min_log_level(level: int) -> None:
    _logger.setLevel(level)


def _emit(level_name: str, level: int, msg: str, *args):
    if args:
        msg = msg % args
    if _sink is not None and _sink(level_name, msg):
        return
    _logger.log(level, msg, stacklevel=3)


def log_verbose(msg, *args):
    _emit("VERBOSE", _pylog.DEBUG, msg, *args)


def log_info(msg, *args):
    _emit("INFO", _pylog.INFO, msg, *args)


def log_warning(msg, *args):
    _emit("WARNING", _pylog.WARNING, msg, *args)


def log_error(msg, *args):
    _emit("ERROR", _pylog.ERROR, msg, *args)


def log_fatal(msg, *args):
    _emit("FATAL", _pylog.CRITICAL, msg, *args)
    raise RuntimeError(msg % args if args else msg)


def check(cond, msg="CHECK failed"):
    if not cond:
        log_fatal(msg)


def check_eq(a, b, msg=""):
    if a != b:
        log_fatal(f"CHECK_EQ failed: {a!r} != {b!r} {msg}")
