"""Stable Diffusion for the benchmark's reference: a frozen copy of the
arithmetic of fairdiff_torch/sampling/pipeline.py (CLIP text -> CFG UNet,
[uncond; cond] a step, inside the DPM-Solver++ 2M loop -> VAE decode) on the
reference's plain modules, in the precision of their weights (fp32 here).
LoRA adapters are merged in fp32 (W + (down @ up)^T) and passed with
`torch.func.functional_call`, so a gradient reaches `down` and `up`. Batches
run in chunks of `chunk` lanes, so the fp32 attention fits."""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from benchmark.reference import dpm_solver as dpm
from benchmark.reference import lora as lora_lib
from benchmark.reference.autoencoder_kl import AutoencoderKL, VAEConfig
from benchmark.reference.clip_text import CLIPTextConfig, CLIPTextModel
from benchmark.reference.unet2d import UNet2DCondition, UNetConfig


def eos_attention_mask(input_ids: torch.Tensor, eos_token_id: int) -> torch.Tensor:
    """Valid through the FIRST eos (CLIP pads with eos); all valid when
    there is no eos."""
    is_eos = input_ids == eos_token_id
    first = is_eos.int().argmax(dim=1)
    has = is_eos.any(dim=1)
    idx = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
    return torch.where(has[:, None], idx <= first[:, None], True).int()


@dataclasses.dataclass(frozen=True)
class SDConfig:
    text: CLIPTextConfig = CLIPTextConfig()
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    solver: dpm.DPMSolverConfig = dpm.DPMSolverConfig()


class RefSD:
    """The three models on one device, weights as the caller sets them."""

    def __init__(self, config: SDConfig, device: torch.device | str, chunk: int = 4):
        self.config, self.device, self.chunk = config, torch.device(device), chunk
        with torch.device(self.device):
            self.text_encoder = CLIPTextModel(config.text)
            self.unet = UNet2DCondition(config.unet)
            self.vae = AutoencoderKL(config.vae)
        for m in self.models().values():
            m.eval().requires_grad_(False)
        self.schedule = dpm.make_schedule(config.solver)

    def models(self) -> dict[str, torch.nn.Module]:
        return {"text_encoder": self.text_encoder, "unet": self.unet, "vae": self.vae}

    def encode(self, ids: torch.Tensor, te_lora: Optional[Mapping] = None) -> tuple[torch.Tensor, torch.Tensor]:
        ids = ids.to(self.device).long()
        mask = eos_attention_mask(ids, self.config.text.eos_token_id)
        weights = lora_lib.apply_lora(self.text_encoder, te_lora) if te_lora is not None else {}
        out = functional_call(self.text_encoder, weights, (ids,), {"attention_mask": mask})
        return out["last_hidden_state"], mask

    def build_context(self, cond_ids, uncond_ids, n: int, te_lora: Optional[Mapping] = None):
        """-> (context [2n, S, C], key mask [2n, S]) in CFG order [uncond; cond]."""
        cond, cmask = self.encode(cond_ids, te_lora)
        uncond, umask = self.encode(uncond_ids, te_lora)
        b = lambda x: x.expand(n, *x.shape[1:])
        return torch.cat([b(uncond), b(cond)]), torch.cat([b(umask), b(cmask)])

    def unet_eps(self, lat2, t: int, context, key_mask, weights: Optional[Mapping] = None):
        return functional_call(self.unet, dict(weights or {}), (lat2, t, context, key_mask))

    def decode(self, latents: torch.Tensor, grad_mode: bool = False) -> torch.Tensor:
        """Final latents -> images in [-1, 1], NHWC, fp32; with grad_mode one
        image at a time, recomputed in the backward."""
        latents = latents / self.config.vae.scaling_factor
        if grad_mode:
            images = torch.cat([checkpoint(self.vae.decode, z[None], use_reentrant=False) for z in latents])
        else:
            images = torch.cat([self.vae.decode(z) for z in latents.split(self.chunk)])
        return images.float().clamp(-1.0, 1.0)

    @torch.no_grad()
    def generate(self, noises, cond_ids, uncond_ids, num_steps: int, guidance_scale: float, *,
                 te_lora=None, unet_lora=None, return_latents: bool = False):
        """encode -> denoise -> decode, `chunk` lanes at a time. -> images
        [N, H, W, 3], with return_latents also (final latents, trajectory
        [T, N, h, w, 4] of the per-step UNet inputs)."""
        noises = noises.to(self.device).float()
        weights = lora_lib.apply_lora(self.unet, unet_lora) if unet_lora is not None else None
        bundle = dpm.make_step_bundle(self.config.solver, self.schedule, num_steps)
        out_img, out_lat, out_traj = [], [], []
        for z in noises.split(self.chunk):
            context, mask = self.build_context(cond_ids, uncond_ids, z.shape[0], te_lora)
            eps_fn = lambda lat2, t: self.unet_eps(lat2, t, context, mask, weights)
            lat, traj = dpm.denoise(eps_fn, z, bundle, guidance_scale=guidance_scale, return_trajectory=True)
            out_img.append(self.decode(lat))
            out_lat.append(lat)
            out_traj.append(traj)
        images = torch.cat(out_img)
        if return_latents:
            return images, torch.cat(out_lat), torch.cat(out_traj, dim=1)
        return images
