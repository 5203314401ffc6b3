"""The fused radiance MLP (B2): both hidden layers and the sigma/rgb heads
in one pass, weights resident on chip.

Port of ``repro.kernels.fused_nerf_mlp.fused_nerf_mlp`` (a Pallas TPU
kernel) as a hand-written CUDA kernel, ``csrc/fused_nerf_mlp.cu``: both
layers and the heads on the tensor cores (TF32 ``mma.sync``) in fp32
accuracy through the 3xTF32 split; see the note there for its bound and
design. The heads run as one product with the folded weight of
:func:`fold_heads`.

``feats [S, C]``, ``direnc [S, DD]`` (the 9-wide direction code, unpadded),
``w1 [C, H]``, ``b1 [H]``, ``w2 [H, H]``, ``b2 [H]``, ``w_sigma [H, 1]``,
``w_rgb [H + DD, 3]``, ``b_rgb [3]``, all float32 -> ``[S, 4]`` =
(softplus sigma, sigmoid rgb). Hidden width H is 32, 64 or 128.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.nerf.mlp import softplus

KERNEL = CudaKernel("fused_nerf_mlp",
                    {"fused_nerf_mlp_f32": "ppppppppppiiiip"})
HIDDEN_WIDTHS = (32, 64, 128)
MAX_DIR_WIDTH = 16  # two k tiles of 8 (kMaxDt in the source)
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def fold_heads(w_sigma: torch.Tensor, w_rgb: torch.Tensor) -> torch.Tensor:
    """The sigma and rgb heads as one ``[H + DDP, 8]`` weight over ``[h,
    d]`` (``DDP``: the direction code's width rounded up to 8, 16 for the
    9-wide code): column 0 is ``w_sigma`` above zeros, columns 1-3
    ``w_rgb`` above zero rows for the padding, columns 4-7 zeros. With
    ``[h, d]`` zero-padded to ``H + DDP`` columns, ``softplus(col 0)`` is
    sigma and ``sigmoid(cols 1-3 + b_rgb)`` is rgb: the padding adds exact
    zeros. The kernel stages this matrix (its rows in B-fragment order)."""
    h = w_sigma.shape[0]
    dd = w_rgb.shape[0] - h
    ddp = -(-dd // 8) * 8
    out = w_rgb.new_zeros((h + ddp, 8))
    out[:h, 0] = w_sigma[:, 0]
    out[:h + dd, 1:4] = w_rgb
    return out


def smem_bytes(c: int, h: int, dd: int) -> int:
    """Shared memory the kernel stages: each weight matrix split into TF32
    hi and lo in B-fragment order (8 floats a weight), layer 1's K and the
    direction code padded to multiples of 8, then ``b1``, ``b2`` and
    ``b_rgb`` in fp32 (``smem_bytes`` in ``csrc/fused_nerf_mlp.cu``)."""
    nt = h // 8
    frags = -(-c // 8) * nt + nt * nt + nt + -(-dd // 8)
    return frags * 32 * 16 + 4 * (2 * h + 3)


def fused_nerf_mlp_plain(feats, direnc, w1, b1, w2, b2, w_sigma, w_rgb,
                         b_rgb) -> torch.Tensor:
    """Plain PyTorch version of the same function."""
    h = torch.relu(feats @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    sigma = softplus(h @ w_sigma)
    rgb = torch.sigmoid(torch.cat([h, direnc], dim=-1) @ w_rgb + b_rgb)
    return torch.cat([sigma, rgb], dim=-1)


def fused_nerf_mlp(feats, direnc, w1, b1, w2, b2, w_sigma, w_rgb,
                   b_rgb) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel
    (anything else raises)."""
    args = (feats, direnc, w1, b1, w2, b2, w_sigma, w_rgb, b_rgb)
    if feats.device.type == "cpu":
        return fused_nerf_mlp_plain(*args)
    if feats.device.type != "cuda":
        raise ValueError(f"fused_nerf_mlp: no kernel for device "
                         f"{feats.device}")
    s, c = feats.shape
    dd = direnc.shape[1]
    h = w1.shape[1]
    if h not in HIDDEN_WIDTHS:
        raise ValueError(f"fused_nerf_mlp: hidden width {h} not in "
                         f"{HIDDEN_WIDTHS}")
    if dd > MAX_DIR_WIDTH:
        raise ValueError(f"fused_nerf_mlp: direction code width {dd} over "
                         f"{MAX_DIR_WIDTH}")
    want = {"feats": (s, c), "direnc": (s, dd), "w1": (c, h), "b1": (h,),
            "w2": (h, h), "b2": (h,), "w_sigma": (h, 1),
            "w_rgb": (h + dd, 3), "b_rgb": (3,)}
    for (name, shape), t in zip(want.items(), args):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_nerf_mlp: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32 or t.device != feats.device:
            raise TypeError(f"fused_nerf_mlp: {name} must be float32 on "
                            f"{feats.device}")
    if smem_bytes(c, h, dd) > _SMEM_LIMIT:
        raise ValueError("fused_nerf_mlp: weights exceed shared memory")
    args = tuple(t.contiguous() for t in args)
    out = torch.empty((s, 4), dtype=torch.float32, device=feats.device)
    if s == 0:
        return out
    with torch.cuda.device(feats.device):
        KERNEL.call("fused_nerf_mlp_f32", *(t.data_ptr() for t in args),
                    out.data_ptr(), s, c, h, dd,
                    torch.cuda.current_stream().cuda_stream)
    return out
