"""The fused radiance MLP (B2): both hidden layers and the sigma/rgb heads
in one pass, weights resident on chip.

Port of ``repro.kernels.fused_nerf_mlp.fused_nerf_mlp`` (a Pallas TPU
kernel) as a hand-written CUDA kernel, ``csrc/fused_nerf_mlp.cu``; see the
note there for its bound and design.

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
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


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
    weights = c * h + h + h * h + h + h + (h + dd) * 3 + 3
    if weights * 4 > _SMEM_LIMIT:
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
