"""Spans and counters of the serving path (``ErrorSys.search`` and the
bounded engines under it).

Spans are ``torch.profiler.record_function`` ranges, so they land in the
same trace as the card's kernels, on the profiler's own clock: any
``torch.profiler`` session over ``ErrorSys.search`` reads them, and each
stretch in which the card idles falls inside the span that the host was
in. With no profiler recording, ``span`` returns one shared no-op context
(a check of the profiler's flag, well under a microsecond) and records
nothing. The names, a fixed set:

    auncel.search   ErrorSys.search, one per call; every other span nests
                    inside it on the serving thread
    auncel.inputs   the window's queries, bounds and scalars onto the card
    auncel.rank     an engine's prologue: coarse rank, boundary distances,
                    probe expansion, the state it starts from
    auncel.wave     one wave an engine visits, skipped waves included
    auncel.round    one compaction round (A2, tail, dense; the two-phase
                    path's width buckets)
    auncel.sync     one call that blocks the host on the card (``synced``)
    auncel.scan     one call of ``scan_probe_range`` or of a dense pass
    auncel.k1       one K1 wrapper call (``rowscan_scores``), in a scan
    auncel.k2       one K2 wrapper call (``scan_scores``), in a scan
    auncel.merge    one ``merge_topk_verified``, in a scan
    auncel.decide   the decision step of a deciding wave
    auncel.record   the results to the host, and the bookkeeping

Counters are fields of ``ivf_stats`` (``index/aux.py``), counted whether
or not a profiler records: ``synced`` adds one to ``host_syncs`` for every
call it runs, the engines add to ``waves``, ``waves_skipped`` and
``rounds``, and ``ErrorSys`` adds each recorded window to ``nq`` and
``nlist_scanned``.
"""

import contextlib

import torch

# the module, not its counters: index/aux.py imports the ops that import
# this module
from auncel_tpu_torch.index import aux

SEARCH = "auncel.search"
INPUTS = "auncel.inputs"
RANK = "auncel.rank"
WAVE = "auncel.wave"
ROUND = "auncel.round"
SYNC = "auncel.sync"
SCAN = "auncel.scan"
K1 = "auncel.k1"
K2 = "auncel.k2"
MERGE = "auncel.merge"
DECIDE = "auncel.decide"
RECORD = "auncel.record"
NAMES = (SEARCH, INPUTS, RANK, WAVE, ROUND, SYNC, SCAN, K1, K2, MERGE,
         DECIDE, RECORD)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a
    shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def synced(call, *args, **kwargs):
    """``call(*args, **kwargs)`` for a call that blocks the host on the
    card's stream (a read of a device value, a copy from pageable host
    memory onto the card), counted in ``ivf_stats.host_syncs`` and spanned
    as ``auncel.sync``."""
    aux.ivf_stats.host_syncs += 1
    with span(SYNC):
        return call(*args, **kwargs)
