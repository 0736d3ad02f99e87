"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for an entry point's `device=` argument.

    "cuda" (the default everywhere) needs a card and raises without one: the
    CPU runs the plain versions only when the caller asks for "cpu".
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was requested but torch.cuda.is_available() "
                               "is False; pass device='cpu' for the plain versions")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
