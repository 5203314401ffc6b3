"""Small shared utilities: integer rounding, PSNR, device resolution."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def psnr(img: torch.Tensor, ref: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB (the paper's quality metric)."""
    mse = torch.mean((img.float() - ref.float()) ** 2)
    mse = torch.clamp(mse, min=1e-12)
    return 10.0 * torch.log10(data_range**2 / mse)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    first CUDA card. Raises when no card is visible and the caller did not
    ask for the CPU explicitly — the port never drops to the CPU quietly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "run the plain PyTorch path on the CPU")
    return torch.device("cuda")



def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def params_device(params: dict, device: DeviceLike = None) -> torch.device:
    """The device a model's ``params`` run on: that of their tensors, which
    must all lie on one device, and on ``device`` when it is given; for
    params without tensors (the oracle's ``{}``) ``device``, else the CUDA
    card (:func:`resolve_device`). Raises for params on another device."""
    want = None if device is None else torch.device(device)
    found = None
    for t in _tensors(params):
        d = t.device
        for other in (found, want):
            if other is not None and (other.type != d.type or (
                    other.index is not None and d.index is not None
                    and other.index != d.index)):
                raise ValueError(f"params on {d}, expected {other}: move "
                                 f"them to one device (the config's)")
        if found is None:
            found = d
    return found if found is not None else resolve_device(want)


def human_bytes(n: float) -> str:
    """``n`` bytes in binary units, two decimals (the reference's
    ``repro.utils.human_bytes``)."""
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} PiB"
