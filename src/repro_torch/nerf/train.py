"""Fitting NeRF models to the analytic scenes (port of ``repro.nerf.train``).

Two paths:

* :func:`fit_field` regresses the grid and decoder against the analytic
  (sigma, rgb) field at random points (no rendering in the loop); it
  builds the hash and VM models for quality experiments;
* :func:`train_images` is photometric training against ground-truth
  frames, through ``render_rays`` with stratified sample depths.

Both run on ``device``, the CUDA card unless the caller passes
``device="cpu"`` (as every entry point of the port), draw the initial
params and every batch from a ``torch.Generator`` on that device (a
CUDA generator on the card, ``torch.Generator()`` on the CPU) and update
with :mod:`repro_torch.optim`'s functional AdamW, so every step makes new
parameter tensors, as the reference's does. One step of each is
a function of its batch (:func:`field_step`, :func:`image_step`), so a
test can hand in the reference's draws.

Gradients come from autograd through the plain PyTorch path. A model
whose forward pass runs a hand-written kernel (the streaming ``dvgo``
gather, B1; the streaming ``mlp`` decoder, B2) has no gradient there, as
the reference's Pallas kernels have none: :func:`check_trainable` refuses
exactly those configs, on every device.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from repro_torch.nerf import rays, scenes
from repro_torch.nerf.models import NerfModel
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, \
    cosine_warmup
from repro_torch.optim.adamw import tree_flatten
from repro_torch.utils import DeviceLike, resolve_device

WARMUP_STEPS = 20


def check_trainable(model: NerfModel) -> None:
    """Raise ``ValueError`` for a config whose forward pass runs a kernel
    autograd cannot see: the streaming backend's ``dvgo`` gather and its
    ``mlp`` decoder (the reference's ``jax.grad`` raises for the same
    configs, whose forward pass reaches a ``pallas_call``). The oracle's
    field is analytic on either backend."""
    c = model.cfg
    if c.backend != "streaming" or c.kind == "oracle":
        return
    if c.kind == "dvgo" or c.decoder == "mlp":
        part = ("the MVoxel gather (B1)" if c.kind == "dvgo"
                else "the fused MLP decoder (B2)")
        raise ValueError(
            f"cannot train a {c.kind!r} model on the streaming backend: "
            f"{part} has no gradient; train the same config with "
            "backend='reference' and render the fitted params through the "
            "streaming model")


def _device(generator: torch.Generator, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator draws on {generator.device}, the "
                         f"run is on {dev}: pass a generator on the run's "
                         "device (device='cpu' for a CPU generator)")
    return dev


def value_and_grad(loss_fn: Callable, params, *args
                   ) -> Tuple[torch.Tensor, object]:
    """(loss, grads) of ``loss_fn(params, *args)``: the grads shaped as
    ``params``, zeros for a leaf the loss does not read (as
    ``jax.value_and_grad``). ``params`` are read, never written."""
    leaves, unflatten = tree_flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(unflatten(live), *args)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, live)]
    return loss.detach(), unflatten(grads)


# ---------------------------------------------------------------------------
# fit_field: regression against the analytic field
# ---------------------------------------------------------------------------


def field_loss(model: NerfModel, params: dict, pts: torch.Tensor,
               dirs: torch.Tensor, sig_t: torch.Tensor,
               rgb_t: torch.Tensor) -> torch.Tensor:
    """The reference's loss (``src/repro/nerf/train.py:27-33``): MSE of
    ``log1p(sigma)`` (density's large dynamic range), plus the rgb MSE
    over the points where the scene is present (``sig_t > 1``),
    normalised by ``3 * sum(w) + 1e-6``."""
    sig, rgb = model.query_field(params, pts, dirs)
    w = (sig_t > 1.0).to(torch.float32)[:, None]
    l_sig = torch.mean((torch.log1p(sig) - torch.log1p(sig_t)) ** 2)
    l_rgb = torch.sum(w * (rgb - rgb_t) ** 2) / (torch.sum(w) * 3.0 + 1e-6)
    return l_sig + l_rgb


def field_batch(generator: torch.Generator, batch: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch on the generator's device: points ``U(-1, 1)^3`` and unit
    directions (normal draws, normalised)."""
    dev = generator.device
    pts = torch.rand((batch, 3), generator=generator, device=dev) * 2.0 - 1.0
    dirs = torch.randn((batch, 3), generator=generator, device=dev)
    return pts, dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def field_step(model: NerfModel, scene: scenes.Scene, params: dict,
               opt: dict, step: int, pts: torch.Tensor, dirs: torch.Tensor,
               *, lr: float, steps: int,
               opt_cfg: AdamWConfig = AdamWConfig(grad_clip_norm=0.0)):
    """One step of :func:`fit_field` on a given batch: the scene's targets
    at ``pts``, the loss and its grads, then AdamW at
    ``cosine_warmup(step, lr, 20, steps)``. Returns (new params, new
    state, loss, grads)."""
    sig_t = scenes.scene_density(scene, pts)
    rgb_t = scenes.scene_albedo(scene, pts)
    loss, grads = value_and_grad(
        lambda p: field_loss(model, p, pts, dirs, sig_t, rgb_t), params)
    lr_t = cosine_warmup(step, lr, WARMUP_STEPS, steps)
    params, opt = adamw_update(grads, params, opt, step, opt_cfg, lr_t)
    return params, opt, loss, grads


def fit_field(model: NerfModel, scene: scenes.Scene,
              generator: torch.Generator, steps: int = 400,
              batch: int = 8192, lr: float = 5e-3,
              device: DeviceLike = None) -> dict:
    """Initialise ``model``'s params from ``generator`` and fit them to the
    scene's analytic field for ``steps`` steps of ``batch`` random points;
    AdamW without a gradient clip. Runs on ``device`` (default: the CUDA
    card), where ``generator`` must draw."""
    check_trainable(model)
    params = model.init(generator, device=_device(generator, device))
    opt_cfg = AdamWConfig(grad_clip_norm=0.0)
    opt = adamw_init(params)
    for s in range(steps):
        pts, dirs = field_batch(generator, batch)
        params, opt, _, _ = field_step(model, scene, params, opt, s, pts,
                                       dirs, lr=lr, steps=steps,
                                       opt_cfg=opt_cfg)
    return params


# ---------------------------------------------------------------------------
# train_images: photometric training
# ---------------------------------------------------------------------------


def image_loss(model: NerfModel, params: dict, origins: torch.Tensor,
               dirs: torch.Tensor, target: torch.Tensor,
               jitter: rays.Jitter) -> torch.Tensor:
    """The reference's loss (``src/repro/nerf/train.py:74-76``): MSE of
    the rendered colour, sample depths stratified by ``jitter`` (see
    :func:`rays.sample_along_rays`)."""
    color, _ = model.render_rays(params, origins, dirs, jitter=jitter)
    return torch.mean((color - target) ** 2)


def image_step(model: NerfModel, params: dict, opt: dict, step: int,
               origins: torch.Tensor, dirs: torch.Tensor,
               target: torch.Tensor, jitter: rays.Jitter, *, lr: float,
               steps: int,
               opt_cfg: AdamWConfig = AdamWConfig(grad_clip_norm=1.0)):
    """One step of :func:`train_images` on a given batch of rays and their
    target colours, sample depths stratified by ``jitter`` (the ``[R, N]``
    offsets, or a generator that draws them). Returns (new params, new
    state, loss, grads)."""
    loss, grads = value_and_grad(
        lambda p: image_loss(model, p, origins, dirs, target, jitter),
        params)
    lr_t = cosine_warmup(step, lr, WARMUP_STEPS, steps)
    params, opt = adamw_update(grads, params, opt, step, opt_cfg, lr_t)
    return params, opt, loss, grads


def train_images(model: NerfModel, gt_renderer: Callable,
                 cam: rays.Camera, poses: Sequence[torch.Tensor],
                 generator: torch.Generator, steps: int = 300,
                 rays_per_batch: int = 4096, lr: float = 5e-3,
                 device: DeviceLike = None) -> Tuple[dict, List[float]]:
    """Photometric training; ``gt_renderer(c2w) -> (rgb [H,W,3], depth)``.

    Renders the ground truth of every pose once, then each step draws
    ``rays_per_batch`` ray indices and their depth offsets from
    ``generator`` and takes one AdamW step (global-norm clip 1.0). Runs
    on ``device`` (default: the CUDA card), where ``generator`` must draw;
    returns (params, one loss a step), each loss read back as the step
    ends, as the reference does."""
    check_trainable(model)
    dev = _device(generator, device)
    params = model.init(generator, device=dev)
    opt_cfg = AdamWConfig(grad_clip_norm=1.0)
    opt = adamw_init(params)
    pose_t = torch.stack([torch.as_tensor(p) for p in poses]).to(dev)
    gt = torch.cat([gt_renderer(p)[0].reshape(-1, 3).to(dev)
                    for p in poses])
    all_o, all_d = rays.generate_rays_batch(cam, pose_t)
    all_o, all_d = all_o.reshape(-1, 3), all_d.reshape(-1, 3)
    losses = []
    for s in range(steps):
        idx = torch.randint(0, all_o.shape[0], (rays_per_batch,),
                            generator=generator, device=dev)
        params, opt, loss, _ = image_step(
            model, params, opt, s, all_o[idx], all_d[idx], gt[idx],
            generator, lr=lr, steps=steps, opt_cfg=opt_cfg)
        losses.append(float(loss))
    return params, losses
