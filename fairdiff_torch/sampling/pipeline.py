"""Stable Diffusion sampling pipeline (counterpart of
fairdiff/sampling/pipeline.py).

CLIP text -> CFG UNet ([uncond; cond] in one call per step) inside the
DPM-Solver++ 2M loop -> VAE decode. The modules hold the frozen weights;
LoRA adapters are merged functionally per call
(`torch.func.functional_call`), so the base weights are never modified and
the merged weights stay differentiable in the adapters. `build_context`,
`unet_eps` and `decode_images(grad_mode=True)` carry gradients to the
adapters and inputs when autograd is on; `generate` runs without autograd
unless `grad_mode=True`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from fairdiff_torch.adapters import lora as lora_lib
from fairdiff_torch.adapters import prefix as prefix_lib
from fairdiff_torch.device import resolve_device
from fairdiff_torch.io import checkpoints as store
from fairdiff_torch.io.from_jax import load_jax_params
from fairdiff_torch.models.autoencoder_kl import AutoencoderKL, VAEConfig
from fairdiff_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from fairdiff_torch.models.layers import init_weights
from fairdiff_torch.models.unet2d import UNet2DCondition, UNetConfig
from fairdiff_torch.sampling import dpm_solver as dpm


def eos_attention_mask(input_ids: torch.Tensor, eos_token_id: int) -> torch.Tensor:
    """The tokenizer's attention mask rebuilt from the ids: valid through
    the FIRST eos (CLIP pads with eos); all valid when there is no eos."""
    is_eos = input_ids == eos_token_id
    first = is_eos.int().argmax(dim=1)
    has = is_eos.any(dim=1)
    idx = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
    valid = idx <= first[:, None]
    return torch.where(has[:, None], valid, True).int()


@dataclasses.dataclass(frozen=True)
class SDConfig:
    text: CLIPTextConfig = CLIPTextConfig.sd15()
    unet: UNetConfig = UNetConfig.sd15()
    vae: VAEConfig = VAEConfig.sd15()
    solver: dpm.DPMSolverConfig = dpm.DPMSolverConfig.sd15()
    guidance_scale: float = 7.5
    dtype: str = "bfloat16"  # compute dtype of the three models

    @classmethod
    def sd15(cls) -> "SDConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "SDConfig":
        return cls(
            text=CLIPTextConfig(
                vocab_size=64,
                hidden_size=32,
                intermediate_size=64,
                num_hidden_layers=2,
                num_attention_heads=4,
                max_position_embeddings=16,
                eos_token_id=63,
            ),
            unet=UNetConfig.tiny(),
            vae=VAEConfig.tiny(),
            dtype="float32",
        )


def _ids(x: Any, device: torch.device) -> torch.Tensor:
    return (x if torch.is_tensor(x) else torch.tensor(np.asarray(x))).to(device).long()


class StableDiffusion:
    """The three models on one device in the config's dtype.

    Weights start uninitialised: call `init_random(seed)`, `load_params(dir)`
    or `load_jax(params)` before use. `flash_bwd` picks the UNet's flash
    backward ("split": K2 + K3, "merged": K6, "recompute": the plain
    attention's autograd)."""

    def __init__(self, config: SDConfig = SDConfig.sd15(), *, device: Optional[str] = None,
                 remat: bool = False, flash_bwd: str = "split"):
        self.config = config
        self.device = resolve_device(device)
        self.dtype = getattr(torch, config.dtype)
        with torch.device(self.device):
            self.text_encoder = CLIPTextModel(config.text)
            self.unet = UNet2DCondition(config.unet, remat=remat, flash_bwd=flash_bwd)
            self.vae = AutoencoderKL(config.vae)
        for m in self.models().values():
            m.to(self.dtype).eval().requires_grad_(False)
        self.schedule = dpm.make_schedule(config.solver)

    def models(self) -> dict[str, torch.nn.Module]:
        return {"text_encoder": self.text_encoder, "unet": self.unet, "vae": self.vae}

    def init_random(self, seed: int) -> "StableDiffusion":
        """Seeded random weights (no checkpoint is needed to run)."""
        g = torch.Generator().manual_seed(seed)
        for m in self.models().values():
            init_weights(m, g)
        return self

    def load_jax(self, params: Mapping) -> "StableDiffusion":
        """Weights from the JAX package's {"text_encoder", "unet", "vae"}
        parameter trees."""
        for name, m in self.models().items():
            load_jax_params(m, params[name])
        return self

    def load_params(self, directory) -> "StableDiffusion":
        """Weights from the port's converted store (`tools/convert_sd`): one
        model at a time, its memory-mapped state dict copied onto the
        pipeline's device and dtype (strict), then released."""
        for name, m in self.models().items():
            m.load_state_dict(store.load_params(directory, [name])[name], strict=True)
        return self

    def latent_shape(self, batch: int) -> tuple[int, int, int, int]:
        s = self.config.unet.sample_size
        return (batch, s, s, self.config.unet.in_channels)

    # -- building blocks ---------------------------------------------------
    def encode_prompt(
        self,
        input_ids: Any,
        attention_mask: Optional[torch.Tensor] = None,
        prefix_table: Optional[torch.Tensor] = None,
        te_weights: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Prompt ids [B, S] -> encoder hidden states [B, S, C]. With a
        prefix table, ids >= vocab_size select its rows. attention_mask=None
        derives the mask from the ids."""
        input_ids = _ids(input_ids, self.device)
        text = self.config.text
        if attention_mask is None:
            attention_mask = eos_attention_mask(input_ids, text.eos_token_id)
        inputs_embeds = None
        if prefix_table is not None:
            inputs_embeds = prefix_lib.splice_prefix_embeds(
                self.text_encoder.token_embedding.weight,
                torch.as_tensor(prefix_table, device=self.device),
                input_ids,
            )
            # pooling and causal shapes still come from clipped ids
            input_ids = input_ids.clamp(max=text.vocab_size - 1)
        out = functional_call(
            self.text_encoder, dict(te_weights or {}), (input_ids,),
            {"attention_mask": attention_mask, "inputs_embeds": inputs_embeds},
        )
        return out["last_hidden_state"]

    def build_context(
        self,
        cond_ids: Any,  # [1 or N, S]
        uncond_ids: Any,
        N: int,
        *,
        cond_mask: Optional[torch.Tensor] = None,
        uncond_mask: Optional[torch.Tensor] = None,
        te_lora: Optional[Mapping] = None,
        prefix_table: Optional[torch.Tensor] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (context [2N, S, C], key mask [2N, S]) in CFG order
        [uncond; cond], broadcast to N."""
        eos = self.config.text.eos_token_id
        cond_ids = _ids(cond_ids, self.device)
        uncond_ids = _ids(uncond_ids, self.device)
        if cond_mask is None:
            cond_mask = eos_attention_mask(cond_ids, eos)
        if uncond_mask is None:
            uncond_mask = eos_attention_mask(uncond_ids, eos)
        te = lora_lib.apply_lora(self.text_encoder, te_lora) if te_lora is not None else None
        cond = self.encode_prompt(cond_ids, cond_mask, prefix_table, te)
        uncond = self.encode_prompt(uncond_ids, uncond_mask, None, te)
        bcast = lambda x: x.expand(N, *x.shape[1:]) if x.shape[0] == 1 else x
        context = torch.cat([bcast(uncond), bcast(cond)], dim=0)
        key_mask = torch.cat([bcast(uncond_mask), bcast(cond_mask)], dim=0)
        return context, key_mask

    def unet_eps(
        self,
        lat2: torch.Tensor,  # [2B, h, w, 4] CFG-doubled
        t: torch.Tensor | int,
        context: torch.Tensor,  # [2B, S, C]
        key_mask: Optional[torch.Tensor] = None,  # [2B, S]
        *,
        unet_weights: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> torch.Tensor:
        weights = dict(unet_weights or {})
        # the remat UNet recomputes each block with `weights` swapped in again
        return functional_call(self.unet, weights, (lat2, t, context, key_mask), {"weights": weights})

    def decode_images(self, latents: torch.Tensor, *, grad_mode: bool = False) -> torch.Tensor:
        """Final latents -> images in [-1, 1], NHWC, fp32. Without grad_mode
        it decodes in chunks of up to 8 (the decoder's full-resolution
        temporaries grow with the batch); with grad_mode one image at a time,
        each recomputed in the backward (`torch.utils.checkpoint`), so the
        backward holds one image's decoder activations at a time."""
        latents = latents / self.config.vae.scaling_factor
        if grad_mode:
            images = torch.cat([
                checkpoint(self.vae.decode, lat[None], use_reentrant=False) for lat in latents
            ])
        else:
            N = latents.shape[0]
            chunk = next(c for c in (8, 6, 4, 3, 2, 1) if N % c == 0)
            images = torch.cat([self.vae.decode(lc) for lc in latents.split(chunk)], dim=0)
        return images.float().clamp(-1.0, 1.0)

    def generate(
        self,
        noises: Any,  # [N, h, w, 4]
        cond_ids: Any,  # [1 or N, S]
        uncond_ids: Any,
        num_steps: int,
        *,
        cond_mask: Optional[torch.Tensor] = None,
        uncond_mask: Optional[torch.Tensor] = None,
        unet_lora: Optional[Mapping] = None,
        te_lora: Optional[Mapping] = None,
        prefix_table: Optional[torch.Tensor] = None,
        guidance_scale: Optional[float] = None,
        grad_mode: bool = False,
        return_latents: bool = False,
    ):
        """encode -> denoise -> decode. Returns images [N, H, W, 3] in
        [-1, 1], fp32, on the pipeline's device.

        grad_mode=True keeps autograd on through the chain (the reference's
        adjusted direct finetuning, see `dpm_solver.denoise`) and the decode.
        return_latents=True returns (images, final latents, trajectory
        [T, N, h, w, 4] of the per-step UNet inputs)."""
        with torch.set_grad_enabled(grad_mode):
            noises = torch.as_tensor(noises, device=self.device).float()
            N = noises.shape[0]
            gs = self.config.guidance_scale if guidance_scale is None else guidance_scale
            context, key_mask = self.build_context(
                cond_ids, uncond_ids, N,
                cond_mask=cond_mask, uncond_mask=uncond_mask,
                te_lora=te_lora, prefix_table=prefix_table,
            )
            unet_weights = (
                lora_lib.apply_lora(self.unet, unet_lora) if unet_lora is not None else None
            )
            bundle = dpm.make_step_bundle(self.config.solver, self.schedule, num_steps)

            def eps_fn(lat2: torch.Tensor, t: int) -> torch.Tensor:
                return self.unet_eps(lat2, t, context, key_mask, unet_weights=unet_weights)

            out = dpm.denoise(eps_fn, noises, bundle, guidance_scale=gs, grad_mode=grad_mode,
                              return_trajectory=return_latents)
            latents, traj = out if return_latents else (out, None)
            images = self.decode_images(latents, grad_mode=grad_mode)
        return (images, latents, traj) if return_latents else images
