"""The port's public loaders follow its device contract (`fairdiff_torch.device`):
CUDA unless the caller asks for the CPU by name. Called with no device on a
machine without CUDA, each raises naming `device='cpu'`; with
`device="cpu"` each loads onto the CPU. Skipped where CUDA is present (there
the default loads onto the card)."""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from fairdiff_torch.guidance.face_feats import FaceFeatsDB
from fairdiff_torch.io.onnx_bridge import load_scrfd
from fairdiff_torch.models.face_detector import load_detector_npz
from fairdiff_torch.training.model_zoo import load_detector, load_guidance_stack
from fairdiff_torch.training.synthetic import synthetic_stack

DETECTOR = Path(__file__).resolve().parents[1] / "assets" / "detector.npz"


def _scrfd(tmp_path: Path) -> Path:
    path = tmp_path / "det.onnx"
    path.write_bytes(chip_smoke.scrfd_onnx(width=8, seed=3))
    return path


def _face_feats(tmp_path: Path) -> Path:
    path = tmp_path / "face_feats.pkl"
    rng = np.random.default_rng(0)
    with open(path, "wb") as f:
        pickle.dump((rng.normal(size=(6, 4)), rng.integers(0, 2, 6), rng.normal(size=(6, 2))), f)
    return path


def _tensors(out) -> list[torch.Tensor]:
    """The tensors a loader's result holds (weights, features)."""
    if isinstance(out, torch.nn.Module):
        return list(out.parameters())
    if isinstance(out, tuple) and isinstance(out[1], dict):  # load_scrfd: (detect, params)
        return list(out[1].values())
    if isinstance(out, FaceFeatsDB):
        return [out.feats, out.genders]
    if hasattr(out, "classify_fn"):  # a GuidanceStack
        return list(out.classify_fn.parameters()) if isinstance(out.classify_fn, torch.nn.Module) \
            else [out.face_db.feats]
    return []  # load_detector: a detect function


# name -> (loader, its arguments from a temporary directory)
LOADERS = {
    "synthetic_stack": (synthetic_stack, lambda tmp: (("gender",),)),
    "load_detector": (load_detector, lambda tmp: (None, DETECTOR)),
    "load_guidance_stack": (load_guidance_stack,
                            lambda tmp: (chip_smoke.seed_guidance_dir(tmp / "g", seed=1, detector_npz=DETECTOR),
                                         ("gender",))),
    "load_detector_npz": (load_detector_npz, lambda tmp: (DETECTOR,)),
    "load_scrfd": (load_scrfd, lambda tmp: (str(_scrfd(tmp)),)),
    "FaceFeatsDB.from_pickle": (FaceFeatsDB.from_pickle, lambda tmp: (_face_feats(tmp),)),
}


@pytest.mark.parametrize("name", list(LOADERS))
def test_loaders_default_to_the_card(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default is the card")
    loader, make_args = LOADERS[name]
    args = make_args(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loader(*args)
    out = loader(*args, device="cpu")
    assert all(t.device.type == "cpu" for t in _tensors(out))
    if name != "load_detector":
        assert _tensors(out), f"{name}: no tensors found in its result"
