"""Device resolution shared by every entry point of the port.

``device=None`` means the card (``"cuda"``).  Without a card that is an
error, never a silent move to the CPU: the CPU runs only when the caller
asks for it with ``device="cpu"`` (the tests do), and then every kernel
wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
