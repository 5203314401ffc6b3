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
(softplus sigma, sigmoid rgb), at any ``[C, H]``: :func:`mlp_plan` routes
H up to 128 to the tensor-core template of the next width (32, 64 or 128;
the weights zero-padded once per parameter set, :func:`pad_hidden`) where
the staged weights fit one block, and everything else to the run-time-H
mode (fp32 CUDA cores, 64 samples a CTA, register-tiled products over
staged k chunks).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.scene_cache import ParamsToken, SceneCache
from repro_torch.kernels._build import CudaKernel, keep_alive
from repro_torch.nerf.mlp import softplus

KERNEL = CudaKernel("fused_nerf_mlp",
                    {"fused_nerf_mlp_f32": "ppppppppppiiiiip",
                     "fused_nerf_mlp_rt_f32": "pppppppppppiiiiiip"})
HIDDEN_WIDTHS = (32, 64, 128)
MAX_DIR_WIDTH = 16  # two k tiles of 8 (kMaxDt in the source)
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
# run-time-H mode (``csrc/fused_nerf_mlp.cu``): 64 samples a CTA, k chunks of
# 16 staged beside a [16 x 68] A tile, the hidden tile [H padded to 16, 68]
RT_ROWS = 64
RT_STAGE_BYTES = 4 * (16 * 68 + 16 * 64)
_PADDED = SceneCache(max_entries=8)  # padded weight sets, see padded()


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


class MlpPlan(NamedTuple):
    """How the kernel runs one ``[C, H]``: ``mode`` "tensor" (the template
    of hidden ``width``, H padded up to it) or "runtime" (``width`` = H);
    ``tile`` samples a tile (a warp's in the templates, a CTA's in the
    run-time mode); ``smem`` the shared-memory bytes of a CTA; ``scratch``
    the floats of global scratch each CTA takes for its hidden tile when
    that does not fit in shared memory (else 0)."""

    mode: str
    width: int
    tile: int
    smem: int
    scratch: int


def rt_hidden_floats(h: int) -> int:
    """Floats of the run-time mode's hidden tile: H padded to 16 rows of
    64 samples plus 4 floats of row padding."""
    return -(-h // 16) * 16 * (RT_ROWS + 4)


def mlp_plan(c: int, h: int, dd: int) -> MlpPlan:
    """The one routing rule of B2 on the card. H up to 128 with a direction
    code of at most ``MAX_DIR_WIDTH`` takes the template of the next width
    in ``HIDDEN_WIDTHS`` when its staged weights (:func:`smem_bytes`) fit
    one block; any other shape takes the run-time-H mode, whose hidden
    tile stays in shared memory beside its staging where both fit (H up to
    816) and goes to global scratch past that."""
    width = next((w for w in HIDDEN_WIDTHS if w >= h), None)
    if width is not None and dd <= MAX_DIR_WIDTH \
            and smem_bytes(c, width, dd) <= _SMEM_LIMIT:
        return MlpPlan("tensor", width, 16, smem_bytes(c, width, dd), 0)
    hidden = rt_hidden_floats(h)
    if RT_STAGE_BYTES + 4 * hidden <= _SMEM_LIMIT:
        return MlpPlan("runtime", h, RT_ROWS, RT_STAGE_BYTES + 4 * hidden, 0)
    return MlpPlan("runtime", h, RT_ROWS, RT_STAGE_BYTES, hidden)


def rt_grid(s: int, plan: MlpPlan, sms: int) -> int:
    """The run-time-H mode's grid over ``s`` samples: a CTA a tile, at most
    4 CTAs an SM (2 with global scratch, whose tiles each CTA owns)."""
    return min(-(-s // plan.tile), (2 if plan.scratch else 4) * sms)


def pad_hidden(w1, b1, w2, b2, w_sigma, w_rgb, width: int) -> Tuple:
    """The weights with H zero-padded to ``width`` hidden units: zero
    columns of ``w1``, ``b1``, ``w2`` and ``b2``, zero rows of ``w2`` and
    ``w_sigma``, and zero rows of ``w_rgb`` between its H rows and its
    direction-code rows. Exact: a padded unit is relu(0 + 0) = 0 and its
    outgoing weights are 0."""
    c, h = w1.shape
    dd = w_rgb.shape[0] - h
    w1p = w1.new_zeros((c, width))
    w1p[:, :h] = w1
    b1p = b1.new_zeros((width,))
    b1p[:h] = b1
    w2p = w2.new_zeros((width, width))
    w2p[:h, :h] = w2
    b2p = b2.new_zeros((width,))
    b2p[:h] = b2
    wsp = w_sigma.new_zeros((width, 1))
    wsp[:h] = w_sigma
    wrp = w_rgb.new_zeros((width + dd, 3))
    wrp[:h] = w_rgb[:h]
    wrp[width:] = w_rgb[h:]
    return w1p, b1p, w2p, b2p, wsp, wrp


def padded(weights: Tuple, width: int) -> Tuple:
    """:func:`pad_hidden` once per parameter set: cached on the weights'
    identities and versions (an in-place update re-pads)."""
    key = (tuple(ParamsToken(t) for t in weights),
           tuple(t._version for t in weights), width)
    return _PADDED.get_or_build(key, lambda: (
        (out := pad_hidden(*weights, width)),
        sum(t.numel() * t.element_size() for t in out)))


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
    args = tuple(t.contiguous() for t in args)
    out = torch.empty((s, 4), dtype=torch.float32, device=feats.device)
    if s == 0:
        return out
    plan = mlp_plan(c, h, dd)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    with torch.cuda.device(feats.device):
        if plan.mode == "tensor":
            if plan.width != h:
                pad = padded(args[2:8], plan.width)
                keep_alive(pad)  # a captured graph reads it by address
                args = args[:2] + pad + args[8:]
            KERNEL.call("fused_nerf_mlp_f32", *(t.data_ptr() for t in args),
                        out.data_ptr(), s, c, plan.width, dd, plan.smem,
                        stream)
        else:
            sms = torch.cuda.get_device_properties(
                feats.device).multi_processor_count
            grid = rt_grid(s, plan, sms)
            scratch = (torch.empty((grid * plan.scratch,),
                                   dtype=torch.float32, device=feats.device)
                       if plan.scratch else None)
            KERNEL.call("fused_nerf_mlp_rt_f32",
                        *(t.data_ptr() for t in args), out.data_ptr(),
                        None if scratch is None else scratch.data_ptr(), s,
                        c, h, dd, plan.smem, grid, stream)
    return out
