"""Framework error codes (analog of reference src/brpc/errno.proto).

Values mirror the reference's numbering so dashboards/docs translate
1:1: client-side 1001-1012, server-side 2001-2004.
"""

ENOSERVICE = 1001  # service not found
ENOMETHOD = 1002  # method not found
EREQUEST = 1003  # bad request
ERPCAUTH = 1004  # authentication failed
ETOOMANYFAILS = 1005  # too many sub-channel failures (ParallelChannel)
EPCHANFINISH = 1006  # ParallelChannel finished
EBACKUPREQUEST = 1007  # backup request fired (internal trigger)
ERPCTIMEDOUT = 1008  # RPC deadline exceeded
EFAILEDSOCKET = 1009  # connection broken during RPC
EHTTP = 1010  # HTTP-level error
# EOVERCROWDED = "THIS SERVER is overloaded — retry elsewhere": raised
# by socket write backpressure AND by every server-side overload shed
# (admission concurrency gate, tier shares, tenant quotas, batch queue
# caps; server/admission.py SHED_CODES).  The retry policy reissues it
# only against a DIFFERENT replica (client/retry.py).
EOVERCROWDED = 1011
ERDMA = 1012  # ICI/accelerator transport error (reference: ERTMP*)

EINTERNAL = 2001  # server internal error
ERESPONSE = 2002  # bad response
ELOGOFF = 2003  # server stopping, rejecting requests
# ELIMIT = "THIS REQUEST is no longer worth serving — drop": its
# deadline expired while queued (batcher deadline-guard shed).  NOT
# retriable: the budget is gone everywhere, not just here.  Overload
# sheds use EOVERCROWDED instead (see docs/overload.md code mapping).
ELIMIT = 2004

ECANCELED = 2005  # call canceled (StartCancel)
ECLOSE = 2006  # connection closed by peer
# ESTALEEPOCH = "THIS WRITE is fenced — its lease epoch is stale": a
# replicated Put/Delete carried an epoch older than the replica
# group's current leader lease (replication/group.py).  NOT retriable
# under the same lease: the old leader must step down; the client-side
# channel re-resolves the leader and reissues under the new epoch
# (docs/replication.md fencing invariant).
ESTALEEPOCH = 2007

_NAMES = {
    v: k
    for k, v in list(globals().items())
    if k.startswith("E") and isinstance(v, int)
}


def error_text(code: int) -> str:
    import os

    if code in _NAMES:
        return _NAMES[code]
    try:
        return os.strerror(code)
    except (ValueError, OverflowError):
        return f"E{code}"
