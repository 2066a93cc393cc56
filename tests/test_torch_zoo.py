"""fairdiff_torch's real-architecture guidance zoo against the JAX package.

- the face detector at its full config on the repository's trained weights
  (assets/detector.npz): raw heads and the selected faces;
- MobileNetV3-Large at full width, and the tiny configs of CLIP-vision,
  DINOv2 (its grid differs from the position table's, so the cubic resize
  runs) and SFNet (both residual orderings), each with the same weights
  carried by `io.from_jax`;
- `load_guidance_stack` on one temporary directory on both sides;
- the files the port cannot read raise.

Float32 on the CPU, inputs from numpy seeds. Tolerances, stated where used,
are summation-order noise: 1e-4 relative to the output's scale for the
convolution nets (flax's GroupNorm takes var = E[x^2] - E[x]^2, torch's the
two-pass form), 2e-5 absolute for the transformers.
"""

import dataclasses
import pickle
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fairdiff.io import adapters_io as jio
from fairdiff.models import clip_vision as jclip
from fairdiff.models import dinov2 as jdino
from fairdiff.models import face_detector as jdet
from fairdiff.models import mobilenet_v3 as jmnv3
from fairdiff.models import sfnet as jsfnet
from fairdiff.training import model_zoo as jzoo
from fairdiff_torch.io.from_jax import load_jax_params
from fairdiff_torch.models import clip_vision as tclip
from fairdiff_torch.models import dinov2 as tdino
from fairdiff_torch.models import face_detector as tdet
from fairdiff_torch.models import mobilenet_v3 as tmnv3
from fairdiff_torch.models import sfnet as tsfnet
from fairdiff_torch.training import model_zoo as tzoo
from test_torch_models import random_tree

torch.set_num_threads(1)

DETECTOR = Path(__file__).resolve().parents[1] / "assets" / "detector.npz"


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, size=shape).astype(np.float32)


def _close(got, want, rtol):
    """max |got - want| within rtol of want's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-6)


def zoo_tree(module, *init_args, seed: int):
    """Seeded JAX weights for a flax module: `random_tree`, with BatchNorm
    variances kept positive."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *init_args))["params"]
    tree = random_tree(shapes, seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.abs(x) + 0.5 if path[-1].key == "var" else x, tree)


def _faces_close(got, want):
    np.testing.assert_array_equal(got.indicators.numpy(), np.asarray(want.indicators))
    for name in ("bboxes", "landmarks", "scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), atol=1e-3, err_msg=name)


def test_detector_on_trained_weights_matches_jax():
    """Raw heads of every pyramid level, then the decode and the largest-face
    selection at a threshold that half of the anchors pass (the trained
    detector finds no face in noise at its own 0.6)."""
    params = jio.load_adapters(DETECTOR)
    x = _images((2, 128, 128, 3), seed=0)
    cfg = jdet.DetectorConfig()
    jraw = jdet.FaceDetectorNet(cfg).apply({"params": params}, jnp.asarray(x))
    net = tdet.load_detector_npz(DETECTOR)
    with torch.no_grad():
        raw = net(torch.from_numpy(x))
    for name in ("score", "bbox", "kps"):
        assert len(raw[name]) == len(cfg.strides)
        for got, want in zip(raw[name], jraw[name]):
            assert got.shape == want.shape
            _close(got.numpy(), want, 1e-4)
    jdecoded = jdet.decode_detections(jraw, cfg)
    decoded = tdet.decode_detections(raw, tdet.DetectorConfig())
    threshold = float(np.median(np.asarray(jdecoded[0])))
    _faces_close(tdet.select_largest_face(*decoded, threshold), jdet.select_largest_face(*jdecoded, threshold))
    with torch.no_grad():
        got = tdet.make_detect_fn(net, tdet.DetectorConfig())(torch.from_numpy(x))
    _faces_close(got, jdet.make_detect_fn(jdet.FaceDetectorNet(cfg), cfg)(params, jnp.asarray(x)))
    with pytest.raises(ValueError, match="pyramid levels"):
        tdet.decode_detections({k: v[:3] for k, v in raw.items()}, tdet.DetectorConfig())


def test_mobilenet_v3_large_matches_jax():
    x = _images((2, 64, 64, 3), seed=1)
    jnet = jmnv3.MobileNetV3Large(num_classes=80)
    tree = zoo_tree(jnet, jnp.zeros((1, 64, 64, 3)), seed=2)
    want = np.asarray(jnet.apply({"params": tree}, jnp.asarray(x)))
    net = load_jax_params(tmnv3.MobileNetV3Large(80), tree)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    _close(got.numpy(), want, 1e-4)


def test_clip_vision_tiny_matches_jax():
    cfg = jclip.CLIPVisionConfig.tiny()
    x = _images((2, 28, 28, 3), seed=3)
    jnet = jclip.CLIPVisionModel(cfg)
    tree = zoo_tree(jnet, jnp.zeros((1, 28, 28, 3)), seed=4)
    want = jnet.apply({"params": tree}, jnp.asarray(x))
    net = load_jax_params(tclip.CLIPVisionModel(tclip.CLIPVisionConfig.tiny()), tree)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for key in ("image_embeds", "pooler_output"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-5, err_msg=key)


def test_dinov2_tiny_resizes_its_position_grid_like_jax():
    """28x28 input: a 2x2 patch grid against the 4x4 position table, so the
    antialiased cubic resize of the table runs on both sides."""
    cfg = jdino.DINOv2Config.tiny()
    x = _images((2, 28, 28, 3), seed=5)
    jnet = jdino.DINOv2Model(cfg)
    tree = zoo_tree(jnet, jnp.zeros((1, 28, 28, 3)), seed=6)
    want = np.asarray(jnet.apply({"params": tree}, jnp.asarray(x)))
    net = load_jax_params(tdino.DINOv2Model(tdino.DINOv2Config.tiny()), tree)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
        same_grid = net(torch.from_numpy(_images((1, 56, 56, 3), seed=7)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(
        same_grid.numpy(), np.asarray(jnet.apply({"params": tree}, jnp.asarray(_images((1, 56, 56, 3), seed=7)))),
        atol=2e-5)


@pytest.mark.parametrize("pre_act", [False, True])
def test_sfnet_matches_jax(pre_act):
    cfg = dataclasses.replace(jsfnet.SFNetConfig.tiny(), layers=(1, 1, 0, 1), pre_act_residual=pre_act)
    x = _images((2, 32, 32, 3), seed=8)
    jnet = jsfnet.SFNet(cfg)
    tree = zoo_tree(jnet, jnp.zeros((1, 32, 32, 3)), seed=9)
    want = np.asarray(jnet.apply({"params": tree}, jnp.asarray(x)))
    tcfg = tsfnet.SFNetConfig(**dataclasses.asdict(cfg))
    with torch.no_grad():
        got = load_jax_params(tsfnet.SFNet(tcfg), tree)(torch.from_numpy(x))
    _close(got.numpy(), want, 1e-4)
    assert tsfnet.SFNetConfig.for_variant("sfnet20_deprecated") == dataclasses.replace(
        tsfnet.SFNetConfig.sfnet20(), pre_act_residual=True)


@pytest.fixture
def guidance_dir(tmp_path):
    """A guidance directory in the JAX package's layout: the trained
    detector, seeded classifier and face-embedder trees, the embedder's
    variant, a face-feature database."""
    shutil.copyfile(DETECTOR, tmp_path / "detector.npz")
    jio.save_adapters(tmp_path / "classifier.npz",
                      zoo_tree(jmnv3.MobileNetV3Large(num_classes=80), jnp.zeros((1, 64, 64, 3)), seed=10))
    jio.save_adapters(tmp_path / "face_embedder.npz",
                      zoo_tree(jsfnet.SFNet(jsfnet.SFNetConfig.sfnet20()), jnp.zeros((1, 112, 112, 3)), seed=11))
    (tmp_path / "face_embedder_variant.txt").write_text("sfnet20\n")
    rng = np.random.default_rng(12)
    feats = rng.normal(size=(16, 512)).astype(np.float32)
    with open(tmp_path / "face_feats.pkl", "wb") as f:
        pickle.dump((feats, rng.integers(0, 2, size=(16, 1)), rng.normal(size=(16, 2))), f)
    return tmp_path


def test_load_guidance_stack_matches_jax(guidance_dir):
    jstack = jzoo.load_guidance_stack(guidance_dir, ("gender",), dtype=jnp.float32)
    stack = tzoo.load_guidance_stack(guidance_dir, ("gender",), dtype=torch.float32)
    p = jstack.params
    assert stack.clip_feat_fn is None and stack.dino_feat_fn is None
    images = _images((2, 128, 128, 3), seed=13)
    with torch.no_grad():
        _faces_close(stack.detect_fn(torch.from_numpy(images)), jstack.detect_fn(p["detector"], jnp.asarray(images)))
        chips = _images((2, 64, 64, 3), seed=14)
        logits = stack.classify_fn(torch.from_numpy(chips))
        _close(logits.numpy(), jstack.classify_fn(p["classifier"], jnp.asarray(chips)), 1e-4)
        aligned = _images((2, 112, 112, 3), seed=15)
        _close(stack.face_embed_fn(torch.from_numpy(aligned)).numpy(),
               jstack.face_embed_fn(p["face_embed"], jnp.asarray(aligned)), 1e-4)
    np.testing.assert_allclose(stack.slices.extract(logits)["gender"].numpy(),
                               np.asarray(jstack.slices.extract(jnp.asarray(logits.numpy()))["gender"]))
    db = p["face_db"]
    np.testing.assert_allclose(stack.face_db.feats.numpy(), np.asarray(db.feats), atol=1e-6)
    np.testing.assert_array_equal(stack.face_db.genders.numpy(), np.asarray(db.genders))
    assert stack.img_size_small == jstack.img_size_small == 256


@pytest.mark.parametrize("name", ["det_10g.onnx", "clip_vision", "dinov2"])
def test_unreadable_guidance_files_raise(tmp_path, name):
    """A `det_10g.onnx` that is not ONNX fails to parse; the JAX package's
    orbax trees `clip_vision/` and `dinov2/` raise before anything is loaded
    (the directory needs nothing else), naming the port's converter."""
    shutil.copyfile(DETECTOR, tmp_path / "detector.npz")
    target = tmp_path / name
    if name == "det_10g.onnx":
        target.write_bytes(b"onnx")
        with pytest.raises(ValueError):
            tzoo.load_guidance_stack(tmp_path, ("gender",), dtype=torch.float32)
        with pytest.raises(ValueError):
            tzoo.load_detector(target, DETECTOR)
    else:
        target.mkdir()
        with pytest.raises(NotImplementedError, match="orbax.*convert_guidance"):
            tzoo.load_guidance_stack(tmp_path, ("gender",), dtype=torch.float32)


def test_seeded_guidance_dir_loads_on_both_sides(tmp_path):
    """`chip_smoke.seed_guidance_dir` writes the JAX package's format: JAX's loader
    reads it and agrees with the port's on the classifier."""
    chip_smoke.seed_guidance_dir(tmp_path, seed=3, detector_npz=DETECTOR)
    jstack = jzoo.load_guidance_stack(tmp_path, ("gender",), dtype=jnp.float32)
    stack = tzoo.load_guidance_stack(tmp_path, ("gender",), dtype=torch.float32)
    chips = _images((1, 32, 32, 3), seed=16)
    with torch.no_grad():
        _close(stack.classify_fn(torch.from_numpy(chips)).numpy(),
               jstack.classify_fn(jstack.params["classifier"], jnp.asarray(chips)), 1e-4)
        faces = stack.detect_fn(torch.from_numpy(_images((2, 64, 64, 3), seed=17)))
    assert bool(faces.indicators.all())
