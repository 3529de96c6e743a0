"""Device resolution for the port.

Every entry point takes a ``device`` argument (on a mesh, each rank's device
comes from ``core.mesh.rank_device``). ``None`` means the card: with
no CUDA device it raises rather than carry on quietly on the CPU. Only an
explicit ``"cpu"`` runs there, as the parity tests do.

Numerics: float32 matrix products and convolutions run in full float32, not
TF32. The kNN ranks by fp32 squared L2 and must order near-ties as the
reference does, and the CPU parity tests hold fp32 paths to 1e-5. TF32 keeps
about three decimal digits, so both switches are off, here in one place.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
