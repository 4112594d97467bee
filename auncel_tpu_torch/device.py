"""Device set-up: full fp32 on the distance path.

Distance values feed the profile trainer's kscaling value match (1e-5 rel,
``profile/trainer.py``) and the bound check, so matrix products must not
drop to TF32 on the card.
"""

import torch


def resolve(device) -> torch.device:
    """The torch.device for ``device``, after pinning fp32 matmul precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device(device)
