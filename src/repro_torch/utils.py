"""Small shared utilities: integer rounding, PSNR, device resolution, tree
math over nested dicts / lists / tuples of tensors, deterministic seeds
(the port of ``repro.utils``; ``shard_map_compat`` and ``jit_with_name``
are shims over the JAX API and have no twin)."""
from __future__ import annotations

import zlib
from typing import Dict, Iterable, Iterator, Sequence, Union

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


def human_count(n: float) -> str:
    """``n`` in decimal units, two decimals (``repro.utils.human_count``)."""
    for unit in ("", "K", "M", "B", "T"):
        if abs(n) < 1000.0:
            return f"{n:.2f}{unit}"
        n /= 1000.0
    return f"{n:.2f}Q"


def chunked(seq: Sequence, size: int) -> Iterator[Sequence]:
    """``seq`` in consecutive slices of ``size`` (the last may be
    shorter)."""
    for i in range(0, len(seq), size):
        yield seq[i:i + size]


def tree_bytes(tree) -> int:
    """Total bytes of every tensor leaf of a nested dict / list / tuple."""
    return int(sum(t.numel() * t.element_size() for t in _tensors(tree)))


def tree_count(tree) -> int:
    """Total number of elements across every tensor leaf."""
    return int(sum(t.numel() for t in _tensors(tree)))


def tree_finite(tree) -> bool:
    """True iff every tensor leaf is finite (no NaN or Inf). Reads the
    values back, so it synchronizes with a card."""
    return all(bool(torch.isfinite(t.float()).all()) for t in _tensors(tree))


def fold_seed(seed: int, *names: str) -> int:
    """An integer seed derived from ``seed`` and string names, stable
    across processes (the twin of ``repro.utils.fold_rng``: builtin
    ``hash()`` of a str is randomized by PYTHONHASHSEED, ``zlib.crc32`` is
    not). Each name folds its crc32 in; the result is in ``[0, 2**63)``."""
    for name in names:
        seed = (seed * 0x9E3779B1 + zlib.crc32(name.encode("utf-8"))) \
            % 2**63
    return seed


def named_generators(seed: int, names: Iterable[str],
                     device: DeviceLike = "cpu") -> Dict[str, torch.Generator]:
    """One ``torch.Generator`` per name, seeded with
    :func:`fold_seed` ``(seed, name)`` (the twin of ``repro.utils.
    named_keys``)."""
    return {n: torch.Generator(device=device).manual_seed(fold_seed(seed, n))
            for n in names}
