"""Calibration hyperparameters (multipler, std_m); a copy of
``auncel_tpu/profile/hyper.py``.

Parity with the reference's ``hyperparameter.txt`` + ``error_pro::setparam``
(IVF_pro.cpp:240-256): 12 rows of (multipler, std_m) indexed by figure id —
rows 1-8 are the overall-latency experiments, rows 9-12 the effectiveness
experiments, per dataset/config (eval/effect_error.cpp:86-120). The values
below are the reference repo's shipped calibration data (config constants,
reproduced as data for experiment parity).

multipler scales the decided probe count (my_nprobe = stage * multipler);
std_m scales the conservative +std offset in the phi->U lookup. Automatic
tuning of these lives in ``ErrorSys.calibrate`` (error_sys.py) — an
improvement over the reference, which tunes them by hand.
"""

# figure id (1-based) -> (multipler, std_m); reference hyperparameter.txt:1-12
REFERENCE_TABLE = {
    1: (9.3, 1.0),    # SIFT10M  k=100 eps=10%
    2: (6.9, 1.0),    # DEEP10M  k=100 eps=10%
    3: (2.7, 12.0),   # GIST1M   k=100 eps=10%
    4: (11.0, 8.0),   # TEXT10M  k=100 eps=10%
    5: (6.7, 1.0),    # SIFT10M  k=50
    6: (7.9, 6.0),    # SIFT10M  k=10
    7: (10.2, 6.0),   # SIFT10M  eps=5%
    8: (26.5, 1.0),   # SIFT10M  eps=1%
    9: (10.0, 0.2),   # effectiveness: SIFT10M
    10: (4.2, 1.0),   # effectiveness: DEEP10M
    11: (4.5, 1.0),   # effectiveness: GIST1M
    12: (15.0, 1.0),  # effectiveness: TEXT10M
}

DEFAULT_MULTIPLER = 1.0  # error_pro defaults (IVF_pro.h:82-85)
DEFAULT_STD_M = 1.0


def get_params(figure_id: int) -> tuple[float, float]:
    if figure_id not in REFERENCE_TABLE:
        raise KeyError(f"figure id {figure_id} outside 1..12")
    return REFERENCE_TABLE[figure_id]
