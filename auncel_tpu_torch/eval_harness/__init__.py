"""The evaluation harness (port of ``auncel_tpu/eval_harness``): the
bound, effect_error, effect_time, overhead and compare experiments, each a
``run()`` on the card unless given ``device="cpu"`` and a
``python -m auncel_tpu_torch.eval_harness.<experiment>`` command line."""

from auncel_tpu_torch.eval_harness import (
    common, bound, effect_error, effect_time, overhead)

__all__ = ["common", "bound", "effect_error", "effect_time", "overhead"]
