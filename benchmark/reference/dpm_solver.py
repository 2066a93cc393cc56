"""DPM-Solver++ (2M) multistep sampler (a frozen copy of
fairdiff_torch/sampling/dpm_solver.py for the benchmark's reference).

The schedule and coefficient tables are the JAX package's (numpy, fp64
computed, stored fp32); `denoise` is a Python loop over them where the JAX
package runs `lax.scan`. Per-step scalars are computed in fp32 with numpy,
as the JAX package computes them on fp32 arrays.

The reference's "adjusted direct finetuning" gradient treatment (a detach
of the latent at every UNet input and a per-step rescale of the guided
epsilon's gradient) is `grad_mode` in `denoise` with `scale_grad`. Under it
the chain is affine in the guided epsilons with schedule-only scalar
coefficients, which `chain_eps_cotangents` computes: the linearized phase 4
of the trainer (docs/LINEARIZED-PHASE4.md) uses them in place of a chain
backward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DPMSolverConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    solver_order: int = 2
    guidance_scale: float = 7.5
    lower_order_final: bool = True

    @classmethod
    def sd15(cls) -> "DPMSolverConfig":
        return cls()


class Schedule(NamedTuple):
    """Per-train-timestep tables (length num_train_timesteps), fp64 -> fp32."""

    alphas_cumprod: np.ndarray
    alpha_t: np.ndarray  # sqrt(acp)
    sigma_t: np.ndarray  # sqrt(1-acp)
    lambda_t: np.ndarray  # log(alpha/sigma)
    alphas: np.ndarray  # 1-beta


def make_schedule(cfg: DPMSolverConfig = DPMSolverConfig()) -> Schedule:
    betas = (
        np.linspace(
            cfg.beta_start**0.5, cfg.beta_end**0.5, cfg.num_train_timesteps,
            dtype=np.float64,
        )
        ** 2
    )
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    alpha_t = np.sqrt(acp)
    sigma_t = np.sqrt(1.0 - acp)
    lambda_t = np.log(alpha_t) - np.log(sigma_t)
    return Schedule(
        acp.astype(np.float32),
        alpha_t.astype(np.float32),
        sigma_t.astype(np.float32),
        lambda_t.astype(np.float32),
        alphas.astype(np.float32),
    )


def timestep_grid(cfg: DPMSolverConfig, num_inference_steps: int) -> np.ndarray:
    """diffusers linspace grid: round(linspace(0, T-1, N+1))[::-1][:-1]."""
    return (
        np.linspace(0, cfg.num_train_timesteps - 1, num_inference_steps + 1)
        .round()[::-1][:-1]
        .astype(np.int64)
    )


class StepBundle(NamedTuple):
    """Per-inference-step coefficient tables (numpy; fp32 unless noted)."""

    t: np.ndarray  # [N] int32, the UNet's conditioning timestep
    sigma_cur: np.ndarray
    alpha_cur: np.ndarray
    lambda_cur: np.ndarray
    sigma_next: np.ndarray
    alpha_next: np.ndarray
    lambda_next: np.ndarray
    lambda_prev: np.ndarray  # lambda at the previous grid point (unused at i=0)
    first_order: np.ndarray  # [N] bool, 1st-order update at this step
    grad_coef: np.ndarray  # [N], the reference's per-step backward rescale


def make_step_bundle(
    cfg: DPMSolverConfig, schedule: Schedule, num_inference_steps: int
) -> StepBundle:
    ts = timestep_grid(cfg, num_inference_steps)
    nxt = np.concatenate([ts[1:], [0]])
    prv = np.concatenate([[ts[0]], ts[:-1]])

    first = np.zeros(len(ts), dtype=bool)
    first[0] = True  # warmup: no previous model output yet
    if cfg.lower_order_final and len(ts) < 15:
        first[-1] = True

    coefs = (
        np.sqrt(schedule.alphas_cumprod[ts])
        * np.sqrt(1.0 - schedule.alphas_cumprod[ts])
        / (1.0 - schedule.alphas[ts])
    ).astype(np.float64)
    coefs = coefs / math.prod(coefs.tolist()) ** (1.0 / len(coefs))

    f32 = lambda a: np.asarray(a, np.float32)
    return StepBundle(
        t=ts.astype(np.int32),
        sigma_cur=f32(schedule.sigma_t[ts]),
        alpha_cur=f32(schedule.alpha_t[ts]),
        lambda_cur=f32(schedule.lambda_t[ts]),
        sigma_next=f32(schedule.sigma_t[nxt]),
        alpha_next=f32(schedule.alpha_t[nxt]),
        lambda_next=f32(schedule.lambda_t[nxt]),
        lambda_prev=f32(schedule.lambda_t[prv]),
        first_order=first,
        grad_coef=f32(coefs),
    )


def dpm_step(
    x0: torch.Tensor,
    sample: torch.Tensor,
    m_prev: torch.Tensor,
    step: StepBundle,
    i: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One DPM-Solver++ 2M update. Returns (new_sample, new_m_prev)."""
    h = step.lambda_next[i] - step.lambda_cur[i]
    ratio = float(step.sigma_next[i] / step.sigma_cur[i])
    coef = float(step.alpha_next[i] * (np.exp(-h) - np.float32(1.0)))
    x_first = ratio * sample - coef * x0
    if step.first_order[i]:
        return x_first, x0
    r0 = (step.lambda_cur[i] - step.lambda_prev[i]) / h
    d1 = (x0 - m_prev) / float(r0 if r0 != 0 else np.float32(1.0))
    return x_first - float(np.float32(0.5) * coef) * d1, x0


class ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward scales the cotangent by `coef` (the
    reference's register_hook on the guided epsilon; `scale_grad`)."""

    @staticmethod
    def forward(ctx, x, coef: float):
        ctx.coef = coef
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.coef, None


def scale_grad(x: torch.Tensor, coef: float) -> torch.Tensor:
    return ScaleGrad.apply(x, float(coef))


def chain_eps_cotangents(bundle: StepBundle) -> torch.Tensor:
    """Per-step scalar d(x_final)/d(eps_guided_t) times the per-step rescale
    coefficient, [T] fp32 (the JAX function of the same name).

    With the UNet input detached, the solver chain is affine in the guided
    epsilons with scalar coefficients, so autograd through a scalar replay
    of `dpm_step` from x_init = 0 gives the exact gamma_t:
        cot(eps_t) = grad_coef_t * gamma_t * dL/dx_final."""
    n = len(bundle.t)
    eps = torch.zeros(n, dtype=torch.float32, requires_grad=True)
    with torch.enable_grad():
        sample = m_prev = torch.zeros((), dtype=torch.float32)
        for i in range(n):
            x0 = (sample - float(bundle.sigma_cur[i]) * eps[i]) / float(bundle.alpha_cur[i])
            sample, m_prev = dpm_step(x0, sample, m_prev, bundle, i)
        (gamma,) = torch.autograd.grad(sample, eps)
    return gamma * torch.from_numpy(np.asarray(bundle.grad_coef, np.float32))


def denoise(
    eps_fn: Callable[[torch.Tensor, int], torch.Tensor],
    latents: torch.Tensor,
    bundle: StepBundle,
    *,
    guidance_scale: float = 7.5,
    grad_mode: bool = False,
    return_trajectory: bool = False,
):
    """Run the denoising chain.

    eps_fn(latents_2B, t) -> eps_2B: the CFG-batched UNet closure, first
    half uncond, second half cond (reference order).

    grad_mode=False runs without autograd. grad_mode=True reproduces the
    reference's adjusted direct finetuning: the UNet sees the detached latent
    and the guided epsilon's gradient is rescaled by the step's `grad_coef`;
    the parameters eps_fn closes over receive gradients from every step.
    (The chain is kept whole for autograd: it is the golden of the
    linearized phase 4, run at small sizes.)

    return_trajectory=True also returns the [T, N, ...] stack of the per-step
    UNet-input latents, from which the linearized phase 4 resumes."""
    with torch.set_grad_enabled(grad_mode):
        sample = latents.float()
        m_prev = torch.zeros_like(sample)
        traj = []
        for i in range(len(bundle.t)):
            unet_in = sample.detach()
            if return_trajectory:
                traj.append(unet_in)
            eps2 = eps_fn(torch.cat([unet_in, unet_in], dim=0), int(bundle.t[i])).float()
            eps_u, eps_c = eps2.chunk(2, dim=0)
            eps = eps_u + guidance_scale * (eps_c - eps_u)
            if grad_mode:
                eps = scale_grad(eps, bundle.grad_coef[i])
            x0 = (sample - float(bundle.sigma_cur[i]) * eps) / float(bundle.alpha_cur[i])
            sample, m_prev = dpm_step(x0, sample, m_prev, bundle, i)
    if return_trajectory:
        return sample, torch.stack(traj)
    return sample
