"""The port's device rule: a function that puts tensors on a device takes
``device``; None means the CUDA card, and where no card is visible that
raises rather than running on the host. The CPU runs only when asked for
(``device="cpu"``)."""

from __future__ import annotations

import torch

from .error import LibError


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``. None means the CUDA card; where no
    card is visible that raises rather than running on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise LibError("no CUDA device is visible: pass device='cpu' "
                           "to run on the host")
        return torch.device("cuda")
    return torch.device(device)
