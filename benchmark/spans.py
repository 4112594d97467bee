"""The program's own spans in a traced run, reduced per name.

``auncel_tpu_torch`` opens ``record_function`` spans named ``auncel.*``
on its serving path (``auncel_tpu_torch/tracing.py``). They land in the
same profiler trace as the card's operations, so over the traced windows
(``bench.window`` spans, on the serving thread) each name gets:

* ``count``: spans opened;
* ``wall_s``: their durations;
* ``self_s``: their durations less what their direct ``auncel.*``
  children cover (aten ops are not children): the spans' self times
  partition the time inside ``auncel.search``;
* ``idle_s``: the part of the self time in which no device operation ran
  (``Tracer.dev``: the program's annotations on the device timeline are
  not operations, ``trace.split_events``);
* ``wall_idle_s``: the same over the whole span.

Each is divided by the traced queries. The program's counters are read off
the same spans: every ``auncel.sync`` is one ``ivf_stats.host_syncs``, an
``auncel.wave`` that holds an ``auncel.scan`` one ``waves`` (the others
``waves_skipped``), an ``auncel.round`` one ``rounds``; the run counts
them over exactly the traced queries, where ``ivf_stats`` counts from
process start (set-up and calibration included).

The readers under ``metrics/`` take a record; ``of(rec)`` fills
``rec["spans"]`` and ``rec["counters"]`` on first use from the run that
calls them (the ``tracer`` and ``traffic`` of ``run.run``'s frame), and
leaves them None where the trace holds no ``auncel.search`` span: a
program without these spans, or a run without a trace.
"""

import sys

import numpy as np

from benchmark import trace

PREFIX = "auncel."
SEARCH, WAVE, ROUND = "auncel.search", "auncel.wave", "auncel.round"
SCAN, SYNC = "auncel.scan", "auncel.sync"
FIELDS = ("wall_s", "self_s", "idle_s", "wall_idle_s")
# frames searched above a reader for the run that calls it
DEPTH = 12


def _busy_before(busy: np.ndarray):
    """t -> ns of the disjoint sorted intervals ``busy`` before t."""
    if not len(busy):
        return lambda t: np.zeros(np.shape(t), np.int64)
    s, e = busy[:, 0], busy[:, 1]
    before = np.r_[0, np.cumsum(e - s)[:-1]]

    def f(t):
        t = np.asarray(t, np.int64)
        k = np.searchsorted(s, t, side="right") - 1
        kc = np.clip(k, 0, None)
        got = before[kc] + np.clip(t - s[kc], 0, e[kc] - s[kc])
        return np.where(k >= 0, got, 0)
    return f


def summarize(tracer, window: int) -> tuple:
    """(per-name record, counters) of the traced windows of ``window``
    queries each; (None, None) without a window or an ``auncel.search``
    span."""
    wins = sorted((h for h in tracer.host if h[2] == trace.WINDOW_SPAN),
                  key=lambda h: h[0])
    if not wins:
        return None, None
    lo, hi, thread = wins[0][0], wins[-1][1], wins[0][3]
    ev = sorted(((h[0], h[1], h[2]) for h in tracer.host
                 if h[3] == thread and h[2].startswith(PREFIX)
                 and h[0] >= lo and h[1] <= hi),
                key=lambda h: (h[0], -h[1]))
    if not any(h[2] == SEARCH for h in ev):
        return None, None
    dev = [d for d in tracer.dev if d[1] > lo and d[0] < hi]
    busy = trace._union(np.array([max(d[0], lo) for d in dev], np.int64),
                        np.array([min(d[1], hi) for d in dev], np.int64))
    before = _busy_before(busy)

    # parents by one sweep over the nested spans; self pieces between the
    # direct children
    parent, stack = [-1] * len(ev), []
    for i, (s, _, _) in enumerate(ev):
        while stack and ev[stack[-1]][1] <= s:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    children: dict = {}
    for i, p in enumerate(parent):
        children.setdefault(p, []).append(i)
    a, b, owner = [], [], []
    for i, (s, e, _) in enumerate(ev):
        t = s
        for c in children.get(i, []):
            a.append(t)
            b.append(max(t, ev[c][0]))
            owner.append(i)
            t = max(t, ev[c][1])
        a.append(t)
        b.append(max(t, e))
        owner.append(i)
    a, b = np.array(a, np.int64), np.array(b, np.int64)
    piece_idle = (b - a) - (before(b) - before(a))
    starts = np.array([h[0] for h in ev], np.int64)
    ends = np.array([h[1] for h in ev], np.int64)
    per_span = {
        "wall_s": ends - starts,
        "self_s": np.bincount(owner, b - a, len(ev)),
        "idle_s": np.bincount(owner, piece_idle, len(ev)),
        "wall_idle_s": (ends - starts) - (before(ends) - before(starts))}

    n_q = len(wins) * window
    names = sorted({h[2] for h in ev})
    by_name = {}
    for name in names:
        sel = np.array([h[2] == name for h in ev])
        rec = {"count": int(sel.sum()) / n_q}
        for f in FIELDS:
            rec[f] = float(per_span[f][sel].sum()) * 1e-9 / n_q
        by_name[name] = rec

    # a wave launched a scan when some scan lies under it
    launched = set()
    for i, h in enumerate(ev):
        if h[2] != SCAN:
            continue
        p = parent[i]
        while p >= 0 and ev[p][2] not in (WAVE, ROUND):
            p = parent[p]
        if p >= 0 and ev[p][2] == WAVE:
            launched.add(p)
    n_waves = sum(h[2] == WAVE for h in ev)
    counters = {"nq": n_q, "host_syncs": sum(h[2] == SYNC for h in ev),
                "waves": len(launched),
                "waves_skipped": n_waves - len(launched),
                "rounds": sum(h[2] == ROUND for h in ev)}
    return by_name, counters


def _traced_run():
    """(tracer, queries a window, error stream) of the ``run.run`` above
    the calling reader, or None."""
    f = sys._getframe(1)
    for _ in range(DEPTH):
        if f is None:
            return None
        got = f.f_locals
        if isinstance(got.get("tracer"), trace.Tracer) and "traffic" in got:
            return (got["tracer"], int(got["traffic"]["window"]),
                    got.get("err") or sys.stderr)
        f = f.f_back
    return None


def of(rec: dict):
    """``rec["spans"]``, filled on first use (with ``rec["counters"]``)
    from the traced run that calls the reader; None without it."""
    if "spans" not in rec:
        rec["spans"] = rec["counters"] = None
        run = _traced_run() if rec.get("n_windows") else None
        if run is not None:
            tracer, window, err = run
            rec["spans"], rec["counters"] = summarize(tracer, window)
            for name, r in (rec["spans"] or {}).items():
                print(f"[bench] span {name}: {r['count']:.2f} a query, "
                      f"wall {1e3 * r['wall_s']:.4f} ms, self "
                      f"{1e3 * r['self_s']:.4f} ms, idle in self "
                      f"{1e3 * r['idle_s']:.4f} ms, idle in all "
                      f"{1e3 * r['wall_idle_s']:.4f} ms", file=err,
                      flush=True)
            if rec["counters"] is not None:
                print(f"[bench] counters over the traced queries: "
                      f"{rec['counters']}", file=err, flush=True)
    return rec["spans"]


def counters(rec: dict):
    """``rec["counters"]`` (see ``of``)."""
    of(rec)
    return rec["counters"]


def self_ms(rec: dict, names: tuple):
    """Self time a query (ms) of the spans ``names``; None without spans."""
    got = of(rec)
    if got is None:
        return None
    return 1e3 * sum(got[n]["self_s"] for n in names if n in got)


def per_query(rec: dict, field: str):
    """A counter over the traced queries a query; None without spans."""
    c = counters(rec)
    if not c or not c["nq"]:
        return None
    return c[field] / c["nq"]
