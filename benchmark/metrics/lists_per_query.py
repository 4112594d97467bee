"""``lists_per_query``: the mean of ``ErrorSys.n_scanned``, the lists each
query scanned, over every query the window served (a program counter)."""


def read(rec: dict):
    n = rec.get("n_scanned")
    if n is None or not len(n):
        return None
    return float(n.mean())
