"""``device.idle_pct``: the share of the traced windows' wall time in which
no device operation ran (profiler timeline)."""


def read(rec: dict):
    if not rec.get("n_windows") or rec["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
