"""Device selection: the port runs on the card unless asked for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """Validate ``device`` and set up the numerics the port relies on.

    A CUDA device without a visible GPU raises instead of falling back to
    the host.  On CUDA, TF32 is switched off for both cuBLAS and cuDNN:
    TF32 keeps ~3 decimal digits, and float32 pre-activations must match
    the reference to rtol 1e-6.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
