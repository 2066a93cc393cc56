"""Offline bias evaluation of generated image folders (counterpart of
fairdiff/tools/eval_images.py, the reference's eval-generated-images.py).

For each prompt folder under `--generated_imgs_dir` (its `*.jpg`, then its
`*.png`, each sorted): read the images into [-1, 1] (`io.images.load_image`,
the port's codec), detect faces in batches of
`--batch_size`, crop the chips, and run the three held-out MobileNetV3-Large
classifiers (gender 2, race 4, age 2 classes; the classifier-level
train/test split) on them; logits are -1 where no face was found. Writes
`<prompt>_grid.jpg` (the annotated grid, a JPEG as the JAX tool writes),
`<prompt>_test_results.pkl` ([indicators, bboxes, gender_logits,
race_logits, age_logits] as numpy arrays, None for a classifier not given)
and `summary.pkl` (the bias metrics by prompt).

Detection runs the stack training uses, in fp32: SCRFD `det_10g.onnx`
through the port's ONNX bridge, composed with the FaceDetectorNet `.npz`
fallback (`training.model_zoo.load_detector`). The classifiers are the JAX
package's `.npz` trees (what `convert_guidance` writes for a classifier).
`--synthetic_smoke 1` uses the synthetic stack's oracle detector and
statistics heads instead.

Usage:
  python -m fairdiff_torch.tools.eval_images --generated_imgs_dir outputs/gen \\
      --scrfd_onnx det_10g.onnx --detector_params assets/detector.npz \\
      --gender_classifier g.npz --race_classifier r.npz --age_classifier a.npz
  python -m fairdiff_torch.tools.eval_images --device cpu --synthetic_smoke 1 \\
      --generated_imgs_dir outputs/gen --save_dir outputs/eval
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from fairdiff_torch.device import resolve_device
from fairdiff_torch.guidance.faces import analyze_faces
from fairdiff_torch.io.adapters_io import load_adapters
from fairdiff_torch.io.from_jax import load_jax_params
from fairdiff_torch.io.images import load_image
from fairdiff_torch.models.mobilenet_v3 import MobileNetV3Large
from fairdiff_torch.training.metrics import multi_attr_metrics
from fairdiff_torch.training.model_zoo import frozen, load_detector
from fairdiff_torch.utils import config as cfglib
from fairdiff_torch.utils.grids import plot_in_grid, plot_in_grid_multi

HEADS = (("gender", 2), ("race", 4), ("age", 2))


@dataclasses.dataclass(frozen=True)
class EvalImagesConfig:
    device: str = ""  # "" = cuda; "cpu" only when asked for
    generated_imgs_dir: str = "outputs/gen-images"
    save_dir: str = "outputs/eval-images"
    # converted held-out classifier params (.npz trees); '' => not run
    gender_classifier: str = ""
    race_classifier: str = ""
    age_classifier: str = ""
    # detection weights, as the training zoo takes them: SCRFD det_10g.onnx
    # primary and/or the FaceDetectorNet .npz fallback; at least one
    scrfd_onnx: str = ""
    detector_params: str = ""
    scrfd_input_size: tuple[int, int] = (640, 640)
    batch_size: int = 32
    chip_size: int = 224
    synthetic_smoke: bool = False  # the oracle detector and the statistics heads


Head = Callable[[torch.Tensor], torch.Tensor]


def _load_stack(cfg: EvalImagesConfig, device: torch.device) -> tuple[Callable, dict[str, Head]]:
    """-> (detect(images) -> FaceDetections, {name: head(chips) -> logits})."""
    if cfg.synthetic_smoke:
        from fairdiff_torch.training.synthetic import oracle_detect, synthetic_classifier

        spans = {"gender": (0, 2), "race": (2, 6), "age": (6, 8)}
        heads = {name: (lambda chips, a=a, b=b: synthetic_classifier(chips)[:, a:b])
                 for name, (a, b) in spans.items()}
        return oracle_detect, heads
    # the detector in its stored fp32, as the reference's onnxruntime eval runs it
    detect = load_detector(cfg.scrfd_onnx or None, cfg.detector_params or None, dtype=torch.float32,
                           device=device, scrfd_input_size=tuple(cfg.scrfd_input_size))
    heads = {}
    for (name, n_cls), path in zip(HEADS, (cfg.gender_classifier, cfg.race_classifier, cfg.age_classifier)):
        if path:
            heads[name] = frozen(load_jax_params(MobileNetV3Large(n_cls), load_adapters(path)),
                                 torch.float32, device)
    return detect, heads


def _softmax(v: np.ndarray) -> np.ndarray:
    # max-subtracted: a confident logit >= ~88 would overflow plain exp to NaN
    e = np.exp(v - v.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@torch.no_grad()
def analyze(detect: Callable, heads: dict[str, Head], images: np.ndarray, chip_size: int,
            device: torch.device) -> tuple[np.ndarray, np.ndarray, dict[str, np.ndarray]]:
    """One batch [N, H, W, 3] in [-1, 1] -> (indicators [N], expanded boxes
    [N, 4], {name: logits [N, classes]}), logits -1 where no face."""
    batch = torch.as_tensor(images, device=device)
    faces = analyze_faces(batch, detect(batch), chip_size=chip_size)
    logits = {name: torch.where(faces.indicators[:, None], head(faces.chips).float(), -1.0).cpu().numpy()
              for name, head in heads.items()}
    return faces.indicators.cpu().numpy(), faces.bboxes.cpu().numpy(), logits


def list_images(prompt_dir: Path) -> list[Path]:
    return sorted(prompt_dir.glob("*.jpg")) + sorted(prompt_dir.glob("*.png"))


def main(cfg: EvalImagesConfig) -> dict:
    device = resolve_device(cfg.device)
    detect, heads = _load_stack(cfg, device)
    root, save_root = Path(cfg.generated_imgs_dir), Path(cfg.save_dir)
    save_root.mkdir(parents=True, exist_ok=True)
    summary = {}
    for prompt_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        files = list_images(prompt_dir)
        if not files:
            continue
        t0 = time.perf_counter()
        imgs = np.stack([load_image(f) for f in files])
        t_read = time.perf_counter() - t0
        t0 = time.perf_counter()
        parts = [analyze(detect, heads, imgs[s: s + cfg.batch_size], cfg.chip_size, device)
                 for s in range(0, len(imgs), cfg.batch_size)]
        t_score = time.perf_counter() - t0
        inds = np.concatenate([p[0] for p in parts])
        bboxes = np.concatenate([p[1] for p in parts])
        logits = {k: np.concatenate([p[2][k] for p in parts]) for k in heads}

        probs = {k: np.where((v != -1).all(-1, keepdims=True), _softmax(v), -1.0) for k, v in logits.items()}
        preds = {k: np.where(inds, v.argmax(-1), -1) for k, v in probs.items()}
        metrics = multi_attr_metrics(probs, preds)
        summary[prompt_dir.name] = metrics

        # gender x race (x age) annotated grid; a single evaluated attribute
        # is annotated alone (never fabricated gender labels)
        attrs = {k: (preds[k], np.where(inds, probs[k].max(-1), -1.0)) for k in ("gender", "race", "age")
                 if k in preds}
        grid = save_root / f"{prompt_dir.name}_grid.jpg"
        if len(attrs) > 1:
            plot_in_grid_multi(imgs, grid, attrs, face_indicators=inds, face_bboxes=bboxes)
        elif preds:
            (name,) = list(preds)
            plot_in_grid(imgs, grid, face_indicators=inds, preds=preds[name], probs_max=probs[name].max(-1))
        with open(save_root / f"{prompt_dir.name}_test_results.pkl", "wb") as f:
            pickle.dump([inds, bboxes, logits.get("gender"), logits.get("race"), logits.get("age")], f)
        print(f"[eval-images] {prompt_dir.name}: {len(files)} images read in {t_read:.2f} s, scored in "
              f"{t_score:.2f} s: {metrics}", flush=True)

    with open(save_root / "summary.pkl", "wb") as f:
        pickle.dump(summary, f)
    return summary


if __name__ == "__main__":
    main(cfglib.cli_parse(EvalImagesConfig))
