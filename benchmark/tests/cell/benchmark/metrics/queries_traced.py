"""``queries_traced``: a metric only the test's own folder has: the number
of queries the traced run served."""


def read(rec: dict):
    n = rec.get("n_scanned")
    return None if n is None else float(len(n))
