"""``kernels_roofline``: the least time the traced windows' scan work
needs at the card's published peaks (``roofline.py``: the lists the engine
decided to scan, 2 d operations a vector, each list read once) as a share
of all device time in those windows."""

from benchmark.roofline import roofline_pct


def read(rec: dict):
    if not rec.get("n_windows") or rec.get("scan_least_s") is None:
        return None
    return roofline_pct(rec["scan_least_s"], rec["kernel_s"])
