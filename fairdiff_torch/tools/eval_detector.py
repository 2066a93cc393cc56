"""Distribution-shift benchmark of a trained fallback face detector
(counterpart of fairdiff/tools/eval_detector.py).

Scores a saved `detector.npz` on the training distribution and on each
shifted suite of `guidance.detector_train.shifted_scene_fns` (blur,
occlusion, scale extremes, off-centre crops, several faces, unseen skin
tones, low contrast, structured backgrounds), one JSON line a shift, then
the false-positive rate once a background family (`fp_rates`: the base
noise and the three background-transforming shifts on face-free scenes).

  python -m fairdiff_torch.tools.eval_detector --weights assets/detector.npz \
      --n_scenes 256 [--json_out shifts.json]
"""

from __future__ import annotations

import dataclasses
import json

import torch

from fairdiff_torch.device import resolve_device
from fairdiff_torch.guidance.detector_train import (
    evaluate_detector, false_positive_rate, shifted_negative_fns, shifted_scene_fns,
)
from fairdiff_torch.io.adapters_io import load_adapters
from fairdiff_torch.io.from_jax import load_jax_params
from fairdiff_torch.models.face_detector import DetectorConfig, FaceDetectorNet, make_detect_fn
from fairdiff_torch.utils import config as cfglib


@dataclasses.dataclass(frozen=True)
class DetEvalConfig:
    device: str = ""  # "" = cuda; "cpu" only when asked for
    weights: str = "assets/detector.npz"
    image_size: int = 128
    n_scenes: int = 256
    seed: int = 777
    tiny: bool = False
    json_out: str = ""
    shifts: str = ""  # comma-separated subset; empty = all
    # 0 keeps DetectorConfig's threshold (0.6); the knob trades recall
    # against the false-positive rate
    score_threshold: float = 0.0


@torch.no_grad()
def main(cfg: DetEvalConfig) -> dict[str, dict[str, float]]:
    device = resolve_device(cfg.device)
    det_cfg = DetectorConfig.tiny() if cfg.tiny else DetectorConfig()
    if cfg.score_threshold > 0:
        det_cfg = dataclasses.replace(det_cfg, score_threshold=cfg.score_threshold)
    net = load_jax_params(FaceDetectorNet(det_cfg), load_adapters(cfg.weights)).to(device).eval()
    detect = make_detect_fn(net.requires_grad_(False), det_cfg)

    fns = shifted_scene_fns(cfg.image_size)
    names = [s for s in cfg.shifts.split(",") if s] or ["train_dist", *sorted(fns)]
    results: dict[str, dict[str, float]] = {}
    for name in names:
        # the shifts transform the face, not the face-free background: fp
        # is priced once a background family below
        m = evaluate_detector(detect, n_scenes=cfg.n_scenes, size=cfg.image_size, seed=cfg.seed,
                              scene_fn=None if name == "train_dist" else fns[name], neg_fn=False, device=device)
        results[name] = m
        print(json.dumps({"shift": name, **{k: round(v, 4) for k, v in m.items()}}), flush=True)

    neg_fns = {"base": None, **shifted_negative_fns(cfg.image_size)}
    fp_rates = {name: false_positive_rate(detect, n_scenes=cfg.n_scenes, size=cfg.image_size, seed=cfg.seed,
                                          neg_fn=fn, device=device)
                for name, fn in neg_fns.items()}
    results["fp_rates"] = fp_rates
    print(json.dumps({"fp_rates": {k: round(v, 4) for k, v in fp_rates.items()}}), flush=True)
    if cfg.json_out:
        with open(cfg.json_out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[eval-detector] wrote {cfg.json_out}", flush=True)
    return results


if __name__ == "__main__":
    main(cfglib.cli_parse(DetEvalConfig))
