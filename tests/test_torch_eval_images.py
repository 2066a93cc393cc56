"""fairdiff_torch.tools.eval_images against the JAX tool on the same PNG
folders: the same pickles and summary.

The folders hold synthetic face scenes (`guidance.detector_train`, 128 px,
faces and face-free scenes) written as PNG, which both tools read (the JAX
one through PIL, the port through its own decoder). Once with the synthetic
stack, once with MobileNetV3-Large heads and the detector written by the
JAX side (`save_adapters`: seeded heads, `assets/detector.npz`'s trained
detector), and once more with a SCRFD-shaped `.onnx` composed over it.
Indicators and summaries must be equal; boxes (int32) equal; logits within
1e-4 (fp32 convolutions summed in other orders).
"""

import pickle

import numpy as np
import pytest
import torch

from chip_smoke import DETECTOR_NPZ
from fairdiff.io.adapters_io import load_adapters as jax_load_adapters
from fairdiff.io.adapters_io import save_adapters as jax_save_adapters
from fairdiff.tools import eval_images as jax_eval
from fairdiff_torch.guidance.detector_train import render_face_scene, render_negative_scene
from fairdiff_torch.io.from_jax import jax_tree_from_module
from fairdiff_torch.io.images import save_png
from fairdiff_torch.models.layers import init_weights
from fairdiff_torch.models.mobilenet_v3 import MobileNetV3Large
from fairdiff_torch.tools import eval_images

torch.set_num_threads(1)

FOLDERS = {"prompt_0": (3, 1), "prompt_1": (4, 0)}  # (faces, face-free) a folder


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen")
    rng = np.random.default_rng(3)
    for name, (n_face, n_free) in FOLDERS.items():
        for i in range(n_face + n_free):
            img = (render_face_scene(rng, 128) if i < n_face else render_negative_scene(rng, 128))[0]
            save_png(img, root / name / f"img_{i}.png")
    return root


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """Heads and detector in the JAX package's `.npz` layout, written by it."""
    from test_onnx_bridge import _scrfd_like_model

    d = tmp_path_factory.mktemp("zoo")
    g = torch.Generator().manual_seed(0)
    for name, n_cls in eval_images.HEADS:  # seeded heads (the JAX eager init takes ~8 s a head on a CPU)
        jax_save_adapters(d / f"{name}.npz", jax_tree_from_module(init_weights(MobileNetV3Large(n_cls), g)))
    jax_save_adapters(d / "detector.npz", jax_load_adapters(DETECTOR_NPZ))
    (d / "det_10g.onnx").write_bytes(_scrfd_like_model())
    return d


def _read(save_dir, name):
    with open(save_dir / f"{name}_test_results.pkl", "rb") as f:
        return pickle.load(f)


def _run_both(tmp_path, folders, batch_size=4, **kw):
    common = dict(generated_imgs_dir=str(folders), batch_size=batch_size, chip_size=64, **kw)
    want = jax_eval.main(jax_eval.EvalImagesConfig(save_dir=str(tmp_path / "jax"), **common))
    got = eval_images.main(eval_images.EvalImagesConfig(device="cpu", save_dir=str(tmp_path / "port"), **common))
    for name in FOLDERS:
        w, g = _read(tmp_path / "jax", name), _read(tmp_path / "port", name)
        assert len(g) == 5
        np.testing.assert_array_equal(g[0], np.asarray(w[0]))
        np.testing.assert_array_equal(g[1], np.asarray(w[1]))
        assert g[1].dtype == np.int32
        for gl, wl in zip(g[2:], w[2:]):
            assert (gl is None) == (wl is None)
            if wl is not None:
                assert gl.dtype == np.float32 and gl.shape == np.asarray(wl).shape
                np.testing.assert_allclose(gl, np.asarray(wl), atol=1e-4, rtol=1e-4)
        assert (tmp_path / "port" / f"{name}_grid.png").exists()
    with open(tmp_path / "port" / "summary.pkl", "rb") as f:
        summary = pickle.load(f)
    assert summary == got
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == pytest.approx(want[name], rel=1e-9, nan_ok=True), name
    return got, [_read(tmp_path / "port", n) for n in FOLDERS]


def test_synthetic_smoke_matches_jax(tmp_path, folders):
    got, pkls = _run_both(tmp_path, folders, batch_size=3, synthetic_smoke=True)  # a part batch a folder
    assert all(p[0].all() for p in pkls)  # the oracle fires on every lane
    assert {"gender_gap", "race_gap", "age_gap"} <= set(got["prompt_0"])


def test_heads_and_detector_match_jax(tmp_path, folders, zoo):
    _, pkls = _run_both(tmp_path, folders, detector_params=str(zoo / "detector.npz"),
                        gender_classifier=str(zoo / "gender.npz"), race_classifier=str(zoo / "race.npz"),
                        age_classifier=str(zoo / "age.npz"))
    inds = pkls[0][0]
    assert inds[:3].sum() >= 2 and not inds[3:].any()  # faces found, the face-free scene empty
    assert (pkls[0][2][~inds] == -1).all()


def test_scrfd_over_the_detector_and_one_head_match_jax(tmp_path, folders, zoo):
    _, pkls = _run_both(tmp_path, folders, scrfd_onnx=str(zoo / "det_10g.onnx"), scrfd_input_size=(32, 32),
                        detector_params=str(zoo / "detector.npz"), race_classifier=str(zoo / "race.npz"))
    assert pkls[0][2] is None and pkls[0][3] is not None and pkls[0][4] is None


def test_cli_parses_and_needs_a_detector(tmp_path, folders):
    from fairdiff_torch.utils.config import cli_parse

    cfg = cli_parse(eval_images.EvalImagesConfig, ["--device", "cpu", "--generated_imgs_dir", str(folders),
                                                   "--save_dir", str(tmp_path), "--scrfd_input_size", "320,320"])
    assert cfg.scrfd_input_size == (320, 320) and not cfg.synthetic_smoke
    with pytest.raises(FileNotFoundError, match="no detector weights"):
        eval_images.main(cfg)
