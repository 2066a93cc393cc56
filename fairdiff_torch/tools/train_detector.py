"""Train the fallback face detector on synthetic scenes (counterpart of
fairdiff/tools/train_detector.py).

The recipe is the JAX tool's, the r5 recipe of docs/DETECTOR.md: Adam at
`--lr` on batches of `--batch_size` domain-randomized (`--scenes dr`) or
base scenes, a `--neg_frac` share of them face-free; from `mine_start_frac`
of the steps on, each step scores `--mine_pool` face-free candidates with
the current weights and appends the `--mine_k` that score highest, and (dr
scenes) `--mine_small_pos` small-face scenes. The weights go to `--out` in
`assets/detector.npz`'s layout (the JAX parameter tree, `|`-joined), which
`models.face_detector.load_detector_npz` and the JAX package's
`load_adapters` read; then the held-out benchmark runs on `--eval_scenes`
fresh scenes.

Usage:
  python -m fairdiff_torch.tools.train_detector --steps 2000 --out outputs/detector.npz
  python -m fairdiff_torch.tools.train_detector --device cpu --tiny 1 --steps 3 --eval_scenes 0
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from fairdiff_torch.device import resolve_device
from fairdiff_torch.guidance.detector_train import (
    detection_loss, evaluate_detector, render_face_scene_dr, render_negative_scene, render_negative_scene_dr,
    synthetic_batches,
)
from fairdiff_torch.io.adapters_io import save_adapters
from fairdiff_torch.io.from_jax import jax_tree_from_module, load_jax_params
from fairdiff_torch.models.face_detector import DetectorConfig, FaceDetectorNet, decode_detections, make_detect_fn
from fairdiff_torch.models.layers import init_weights
from fairdiff_torch.utils import config as cfglib


@dataclasses.dataclass(frozen=True)
class DetTrainConfig:
    device: str = ""  # "" = cuda; "cpu" only when asked for
    steps: int = 2000
    batch_size: int = 16
    image_size: int = 128
    lr: float = 3e-4
    seed: int = 0
    tiny: bool = False
    out: str = "outputs/detector.npz"
    log_every: int = 100
    # hard negatives: face-free scenes and non-face distractor blobs
    neg_frac: float = 0.25
    distractors: int = 2
    scenes: str = "dr"  # "dr": domain-randomized scenes; "base": the r1 renderer
    eval_scenes: int = 256  # 0 disables the held-out eval
    # online hard-negative mining from mine_start_frac of the steps on;
    # mine_k = 0 disables it (the r4 recipe)
    mine_k: int = 4
    mine_pool: int = 64
    mine_start_frac: float = 0.4
    # small-face positives appended beside the mined negatives (dr scenes)
    mine_small_pos: int = 2
    small_pos_scale: tuple[float, float] = (0.12, 0.30)


def main(cfg: DetTrainConfig, init_params: dict | None = None):
    """Train and save; -> (params as a JAX tree of numpy arrays, held-out
    metrics or None, {"loss": [...], "step_s": [...], "mine_start": int}).
    `init_params` (a JAX detector tree) replaces the seeded init."""
    device = resolve_device(cfg.device)
    det_cfg = DetectorConfig.tiny() if cfg.tiny else DetectorConfig()
    net = FaceDetectorNet(det_cfg)
    if init_params is None:
        init_weights(net, torch.Generator().manual_seed(cfg.seed))
    else:
        load_jax_params(net, init_params)
    net = net.to(device)
    opt = torch.optim.Adam(net.parameters(), lr=cfg.lr, eps=1e-8)  # optax.adam's update
    batches = synthetic_batches(cfg.batch_size, cfg.image_size, cfg.seed, neg_frac=cfg.neg_frac,
                                distractors=cfg.distractors, scenes=cfg.scenes)
    # base scenes: mined candidates sample the training negatives' distribution
    neg_render = (render_negative_scene_dr if cfg.scenes == "dr"
                  else (lambda rng, size: render_negative_scene(rng, size, cfg.distractors)))
    mine_rng = np.random.default_rng(cfg.seed + 31337)
    on_device = lambda a: torch.as_tensor(a, device=device)

    mine_start = int(cfg.steps * cfg.mine_start_frac)
    history: dict = {"loss": [], "step_s": [], "mine_start": mine_start}
    for i in range(cfg.steps):
        t0 = time.perf_counter()
        imgs, boxes, lms = next(batches)
        if cfg.mine_k and i >= mine_start:
            pimgs = np.stack([neg_render(mine_rng, cfg.image_size)[0] for _ in range(cfg.mine_pool)])
            with torch.no_grad():
                scores = decode_detections(net(on_device(pimgs)), det_cfg)[0].amax(-1).cpu().numpy()
            top = np.argsort(-scores)[: cfg.mine_k]
            extra_imgs = [pimgs[top]]
            extra_boxes = [np.full((cfg.mine_k, 4), -1.0, np.float32)]
            extra_lms = [np.full((cfg.mine_k, 5, 2), -1.0, np.float32)]
            if cfg.mine_small_pos and cfg.scenes == "dr":
                sp = [render_face_scene_dr(mine_rng, cfg.image_size, lead_scale_range=tuple(cfg.small_pos_scale))
                      for _ in range(cfg.mine_small_pos)]
                extra_imgs.append(np.stack([z[0] for z in sp]))
                extra_boxes.append(np.stack([z[1] for z in sp]).astype(np.float32))
                extra_lms.append(np.stack([z[2] for z in sp]).astype(np.float32))
            imgs = np.concatenate([imgs, *extra_imgs])
            boxes = np.concatenate([boxes, *extra_boxes])
            lms = np.concatenate([lms, *extra_lms])
        opt.zero_grad(set_to_none=True)
        loss, aux = detection_loss(net, on_device(imgs), on_device(boxes), on_device(lms), det_cfg)
        loss.backward()
        opt.step()
        history["loss"].append(loss.item())  # waits for the step
        history["step_s"].append(time.perf_counter() - t0)
        if i % cfg.log_every == 0:
            print(f"[train-detector] {i}: loss={history['loss'][-1]:.4f} cls={aux['cls'].item():.4f} "
                  f"box={aux['box'].item():.4f} kps={aux['kps'].item():.4f}", flush=True)
    params = jax_tree_from_module(net)
    save_adapters(cfg.out, params)
    print(f"[train-detector] saved -> {cfg.out}", flush=True)
    metrics = None
    if cfg.eval_scenes:
        net.eval().requires_grad_(False)
        with torch.no_grad():
            metrics = evaluate_detector(make_detect_fn(net, det_cfg), n_scenes=cfg.eval_scenes,
                                        size=cfg.image_size, seed=cfg.seed + 777, distractors=cfg.distractors,
                                        device=device)
        print("[train-detector] held-out " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()), flush=True)
    return params, metrics, history


if __name__ == "__main__":
    main(cfglib.cli_parse(DetTrainConfig))
