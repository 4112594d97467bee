"""``engine.host_ms``: the mean over the traced windows of a window's wall
time less the time some device operation ran inside it: the time the
bounded search engine's host loop keeps the card waiting."""


def read(rec: dict):
    if not rec.get("n_windows"):
        return None
    idle = [w - b for w, b in zip(rec["window_wall_s"], rec["window_busy_s"])]
    return 1e3 * sum(idle) / len(idle)
