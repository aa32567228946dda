"""Classic (non-accelerated) NeRF training in torch (port of
``nerf_for_angiography_tpu/training/classic.py``): stratified coarse
sampling and hierarchical inverse-CDF fine resampling, no occupancy grid.

The reference's un-accelerated capability set: ``render_volume_density``
with stratified depths (nerf_helpers.py:13-22,59-123,245-257) and the
coarse-to-fine pipeline (``fine_sampling`` / ``sample_pdf``,
nerf_helpers.py:178-222, bit-rotted there and repaired as in the JAX
package). One step runs both passes, both losses and one Adam update over
the coarse and, when there is one, the separate fine model (the reference
passes fine_model=None to share, nerf_helpers.py:190).

The JAX package runs this path through ``model.apply``, outside every
Pallas kernel; so does the port: the module's own forward (``torch``
matmuls in the config's compute dtype), on the card too.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..device import resolve_device
from ..geometry import linspace_depths, query_points, stratify_depths
from ..models import CPPN, barf_alpha_device
from ..ops.occupancy import prune_mask
from ..ops.rendering import fine_sampling_at, pdf_uniforms, psnr_from_mse, render_xray
from ..ops.sampling import RayBatch, RayDataset, sample_pixel_rays
from .config import TrainConfig
from .train import make_optimizer


@dataclasses.dataclass
class ClassicState:
    """The JAX ClassicState in PyTorch form: the coarse module, the separate
    fine module (None: shared weights), one Adam over both and its lr
    schedule, the generator in place of the PRNG key, and the step on the
    host and on the device (the lr and the BARF alphas are computed from
    ``step_dev``)."""

    model: CPPN
    fine_model: CPPN | None
    optimizer: torch.optim.Optimizer
    scheduler: Any
    step: int
    generator: torch.Generator
    step_dev: torch.Tensor | None = None

    def __post_init__(self):
        if self.step_dev is None:
            dev = next(self.model.parameters()).device
            self.step_dev = torch.full((), int(self.step), dtype=torch.int32, device=dev)

    def advance(self) -> None:
        self.step_dev.add_(1)
        self.step += 1


def create_classic_state(
    model: CPPN, cfg: TrainConfig, seed: int = 1, fine_model: CPPN | None = None,
    device: str | torch.device = "cuda",
) -> ClassicState:
    """The classic path's state: ``model`` (and ``fine_model``) moved to
    ``device``, one Adam over both (make_optimizer), the generator seeded
    with ``seed``."""
    dev = resolve_device(device)
    model.to(dev)
    params = list(model.parameters())
    if fine_model is not None:
        fine_model.to(dev)
        params += list(fine_model.parameters())
    opt, sched = make_optimizer(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return ClassicState(model=model, fine_model=fine_model, optimizer=opt, scheduler=sched,
                        step=0, generator=gen)


def make_classic_train_step(
    model: CPPN, cfg: TrainConfig, near: float, far: float, n_fine: int = 64,
    fine_model: CPPN | None = None, entropy_weight: float = 0.0,
):
    """The coarse(+fine) X-ray NeRF step: weighted ray sampling, stratified
    coarse depths, coarse render, inverse-CDF fine depths from the coarse
    weights, fine render, MSE(coarse) + MSE(fine) [+ the entropy term], Adam.
    Returns ``train_step(state, rays) -> (state, metrics)``;
    ``train_step.step_core(state, batch, depths, u_fine)`` runs it on a
    given batch, coarse depths (R, n) and fine uniforms (R, n_fine).
    Gradients stay in ``.grad`` after the step."""
    shared = fine_model is None
    fine = model if shared else fine_model
    use_views = model.config.use_viewdirs
    use_barf = cfg.pos_enc == "barf"
    n = cfg.depth_samples_per_ray

    def alphas(step_dev):
        zero = torch.zeros((), dtype=torch.float32, device=step_dev.device)
        # both BARF windows anneal on the same start/stop schedule
        # (CPPN.py:236-242 exposes the views alpha)
        a_pts = (barf_alpha_device(step_dev, cfg.pos_enc_basis, cfg.barf_start, cfg.barf_stop)
                 if use_barf else zero)
        a_views = (barf_alpha_device(step_dev, cfg.pos_enc_basis_views, cfg.barf_start,
                                     cfg.barf_stop) if use_barf and use_views else zero)
        return a_pts, a_views

    def render(m: CPPN, batch: RayBatch, depths_r, a_pts, a_views):
        pts = query_points(batch.origins, batch.directions, depths_r)
        if use_views:
            # per-ray unit view direction along every sample (run_nerf.py's
            # viewdirs contract; the density head still drives the X-ray
            # composite through [..., -1])
            vd = batch.directions / torch.linalg.norm(batch.directions, dim=-1, keepdim=True)
            inp = torch.cat([pts, vd[:, None, :].expand(pts.shape)], dim=-1)
        else:
            inp = pts
        raw = m(inp.reshape(-1, inp.shape[-1]), a_pts, a_views)
        sigma = torch.sigmoid(raw[..., -1]).reshape(depths_r.shape)
        # finite last segment: the reference's 1e10 tail times a sigmoid
        # density makes every pixel 0 and kills every gradient
        d = depths_r[..., 1:] - depths_r[..., :-1]
        dists = torch.cat([d, d[..., -1:]], dim=-1)
        dists = dists * torch.linalg.norm(batch.directions, dim=-1, keepdim=True)
        # transmittance early stop on detached sigma, as on the accelerated
        # path: at init every ray is opaque and the gradients vanish without it
        keep = prune_mask(sigma, dists, torch.ones_like(sigma),
                          early_stop_eps=cfg.early_stop_eps).detach()
        return render_xray(sigma, depths_r, None, dists=dists, mask=keep)

    def step_core(state: ClassicState, batch: RayBatch, depths: torch.Tensor,
                  u_fine: torch.Tensor):
        a_pts, a_views = alphas(state.step_dev)
        state.optimizer.zero_grad(set_to_none=True)
        coarse = render(model, batch, depths, a_pts, a_views)
        loss_c = torch.mean((coarse.pixels - batch.pixel_values) ** 2)
        fine_depths = fine_sampling_at(depths, coarse.weights, u_fine)
        fine_out = render(fine, batch, fine_depths, a_pts, a_views)
        loss_f = torch.mean((fine_out.pixels - batch.pixel_values) ** 2)
        loss = loss_c + loss_f
        if entropy_weight > 0:
            loss = loss + entropy_weight * fine_out.entropy.mean()
        loss.backward()
        state.scheduler.apply(state.step_dev)
        state.optimizer.step()
        loss_c, loss_f = loss_c.detach(), loss_f.detach()
        metrics = {
            "loss/train-pixel-coarse": loss_c,
            "loss/train-pixel-fine": loss_f,
            "psnr/train-coarse": psnr_from_mse(loss_c),
            "psnr/train-fine": psnr_from_mse(loss_f),
            # the reference's TB tag (run_nerf_acc.py:409) and the views alpha
            "barf-coarse": a_pts,
            "barf-views-coarse": a_views,
        }
        state.advance()
        return state, metrics

    def train_step(state: ClassicState, rays: RayDataset):
        gen = state.generator
        batch = sample_pixel_rays(gen, rays, cfg.img_sample_size,
                                  weighted=cfg.sampling_strategy != "random")
        dev = batch.origins.device
        base = linspace_depths(near, far, n, dev)
        depths = stratify_depths(base.expand(batch.origins.shape[0], n), gen)
        u_fine = pdf_uniforms(depths[:, 1:-2], n_fine, gen)
        return step_core(state, batch, depths, u_fine)

    train_step.step_core = step_core
    return train_step
