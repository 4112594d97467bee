"""``torch_ops.device_ms``: device time a traced window of the kernels of the
``torch_ops`` layer (``layers/torch_ops.json``; ``torch_ops`` takes every kernel
no layer file claims), from the profiler's trace."""

LAYER = "torch_ops"


def read(rec: dict):
    s = rec.get("layer_s", {}).get(LAYER)
    if not rec.get("n_windows") or not s:
        return None
    return 1e3 * s / rec["n_windows"]
