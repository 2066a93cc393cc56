"""The port's converter CLIs end to end on the CPU, against the JAX package.

- `convert_sd --preset tiny` on a tiny diffusers directory written from
  seeded weights (`chip_smoke.write_sd_checkpoint`), then `gen_images
  --model_dir`: PNGs byte-equal to `gen_images` on the same weights made
  in memory (what `[weights]` checks at full width on the card);
- a directory holding the JAX package's orbax trees raises, naming the
  port's converter;
- `convert_guidance` on the reference's files (torchvision MobileNetV3 `.pt`,
  opensphere SFNet `.pth`, HF CLIP-vision as `.safetensors`, DINOv2 `.pth`,
  the face-feature pickle, a det_10g-shaped SCRFD `.onnx`), then
  `load_guidance_stack`, against the JAX stack loaded from the JAX
  converter's output of the same files: `analyze` gives equal detections,
  and probabilities and features within 1e-4;
- `train_debias --model_dir --guidance_dir` for one step on the CPU.

CLIP-vision and DINOv2 run at width 32 (their published configs are
patched to tiny ones on both sides: the stack builds the published widths).
"""

import dataclasses
import json
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

import chip_smoke
from fairdiff.models import clip_vision as jclip
from fairdiff.models import dinov2 as jdino
from fairdiff.tools import convert_guidance as jconvert_guidance
from fairdiff.training import model_zoo as jzoo
from fairdiff_torch.io import checkpoints as store
from fairdiff_torch.models import clip_vision as tclip
from fairdiff_torch.models import dinov2 as tdino
from fairdiff_torch.sampling.pipeline import SDConfig, StableDiffusion
from fairdiff_torch.tools import convert_guidance, convert_sd, gen_images, train_debias
from fairdiff_torch.training import model_zoo as tzoo
from fairdiff_torch.utils import config as cfglib
from test_weights_pipeline_e2e import _write_mobilenet_pt, _write_sfnet_pth

torch.set_num_threads(1)


def test_convert_sd_then_gen_images_reads_the_store(tmp_path):
    sd = StableDiffusion(SDConfig.tiny(), device="cpu").init_random(42)
    chip_smoke.write_sd_checkpoint(sd, tmp_path / "sd")
    convert_sd.main(cfglib.cli_parse(convert_sd.ConvertConfig, [
        "--sd_dir", str(tmp_path / "sd"), "--out_dir", str(tmp_path / "store"), "--preset", "tiny"]))
    assert sorted(p.name for p in (tmp_path / "store").iterdir()) == ["text_encoder.pt", "unet.pt", "vae.pt"]
    loaded = StableDiffusion(SDConfig.tiny(), device="cpu").load_params(tmp_path / "store")
    for name, m in sd.models().items():
        for k, v in m.state_dict().items():
            assert torch.equal(loaded.models()[name].state_dict()[k], v), f"{name}.{k}"

    common = ["--device", "cpu", "--tiny_smoke", "1", "--num_imgs_per_prompt", "2", "--batch_size", "2",
              "--num_denoising_steps", "2"]
    random = gen_images.main(gen_images.parse_args(common + ["--save_dir", str(tmp_path / "random")]))
    stored = gen_images.main(gen_images.parse_args(common + ["--save_dir", str(tmp_path / "stored"),
                                                            "--model_dir", str(tmp_path / "store")]))
    assert [p.name for p in stored] == ["img_0.jpg", "img_1.jpg"]
    assert [p.read_bytes() for p in stored] == [p.read_bytes() for p in random]
    other = StableDiffusion(SDConfig.tiny(), device="cpu").init_random(7)
    chip_smoke.write_sd_checkpoint(other, tmp_path / "sd7")
    convert_sd.main(convert_sd.ConvertConfig(sd_dir=str(tmp_path / "sd7"), out_dir=str(tmp_path / "other"),
                                             preset="tiny"))
    moved = gen_images.main(gen_images.parse_args(common + ["--save_dir", str(tmp_path / "other_gen"),
                                                           "--model_dir", str(tmp_path / "other")]))
    assert moved[0].read_bytes() != random[0].read_bytes()


def test_orbax_trees_raise_naming_the_port_converter(tmp_path):
    for name in store.SD_MODELS:
        (tmp_path / name).mkdir()  # the JAX package's orbax layout
    with pytest.raises(NotImplementedError, match="orbax.*fairdiff_torch.tools.convert_sd"):
        StableDiffusion(SDConfig.tiny(), device="cpu").load_params(tmp_path)
    with pytest.raises(FileNotFoundError, match="convert_sd"):
        store.load_sd_params(tmp_path / "nothing")


@pytest.fixture
def tiny_towers(monkeypatch):
    """The published CLIP-ViT-H/14 and DINOv2 ViT-B/14 configs at width 32
    on both sides (224-px input, so the JAX stack's fixed resize fits)."""
    clip = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                image_size=224, patch_size=14, projection_dim=16)
    dino = dict(hidden_size=32, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                pos_embed_size=4)
    for cls in (jclip.CLIPVisionConfig, tclip.CLIPVisionConfig):
        monkeypatch.setattr(cls, "vit_h14", classmethod(lambda c: c(**clip)))
    for cls in (jdino.DINOv2Config, tdino.DINOv2Config):
        monkeypatch.setattr(cls, "vitb14", classmethod(lambda c: c(**dino)))
    return clip, dino


def _seeded(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in sorted(module.state_dict().items()):
            if v.is_floating_point():
                v.copy_(torch.randn(v.shape, generator=g) * (v[0].numel() ** -0.5 if v.dim() >= 2 else 0.1)
                        + (1.0 if k.endswith("weight") and v.dim() == 1 else 0.0))
    return module.eval()


def write_reference_files(root, clip, dino):
    """The reference's guidance artifacts at fixture scale."""
    from safetensors.torch import save_file

    root.mkdir(parents=True)
    hf_clip = _seeded(transformers.CLIPVisionModelWithProjection(transformers.CLIPVisionConfig(
        **{k: v for k, v in clip.items()}, hidden_act="gelu")), 1)
    (root / "clip").mkdir()
    save_file(hf_clip.state_dict(), root / "clip" / "model.safetensors")
    hf_dino = _seeded(transformers.Dinov2Model(transformers.Dinov2Config(
        hidden_size=32, mlp_ratio=4, num_hidden_layers=2, num_attention_heads=4, patch_size=14,
        image_size=dino["pos_embed_size"] * 14)), 2)
    torch.save(hf_dino.state_dict(), root / "dinov2_vitb14.pth")
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(16, 512)).astype(np.float32)
    with open(root / "face_feats.pkl", "wb") as f:
        pickle.dump((feats, rng.integers(0, 2, size=(16, 1)), rng.normal(size=(16, 2))), f)
    (root / "det_10g.onnx").write_bytes(chip_smoke.scrfd_onnx(width=8, seed=5))
    return dict(classifier_pth=str(_write_mobilenet_pt(root / "CelebA-MobileNetLarge.pt", 80)),
                clip_vision_dir=str(root / "clip"), dinov2_pth=str(root / "dinov2_vitb14.pth"),
                sfnet_pth=str(_write_sfnet_pth(root / "backbone_100000.pth")), sfnet_variant="sfnet20_deprecated",
                face_feats_pkl=str(root / "face_feats.pkl"), detector_onnx=str(root / "det_10g.onnx"))


def convert_both(tmp_path, clip, dino):
    """The same files through both packages' convert_guidance; the
    every-lane-detects detector.npz beside each SCRFD as the fallback."""
    files = write_reference_files(tmp_path / "ref", clip, dino)
    tdir = convert_guidance.main(convert_guidance.GuidanceConvertConfig(out_dir=str(tmp_path / "port"), **files))
    jdir = jconvert_guidance.main(jconvert_guidance.GuidanceConvertConfig(out_dir=str(tmp_path / "jax"), **files))
    chip_smoke.seed_guidance_dir(tmp_path / "seed", seed=4)
    for d in (tdir, jdir):
        shutil.copyfile(tmp_path / "seed" / "detector.npz", d / "detector.npz")
    return tdir, jdir


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-6)


def test_convert_guidance_then_load_guidance_stack_matches_jax(tmp_path, tiny_towers):
    tdir, jdir = convert_both(tmp_path, *tiny_towers)
    assert sorted(p.name for p in tdir.iterdir()) == [
        "classifier.npz", "clip_vision.pt", "det_10g.onnx", "detector.npz", "dinov2.pt", "face_embedder.npz",
        "face_embedder_variant.txt", "face_feats.pkl"]
    stack = tzoo.load_guidance_stack(tdir, ("gender",), dtype=torch.float32, device="cpu")
    jstack = jzoo.load_guidance_stack(jdir, ("gender",), dtype=jnp.float32)
    assert stack.clip_feat_fn and stack.dino_feat_fn and stack.face_embed_fn
    assert stack.detect_fn.__qualname__.startswith("compose_detectors")
    images = np.random.default_rng(6).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = stack.analyze(torch.from_numpy(images))
    want = jax.jit(lambda params, x: jstack.analyze(x, params=params))(jstack.params, jnp.asarray(images))
    np.testing.assert_array_equal(got.faces.indicators.numpy(), np.asarray(want.faces.indicators))
    assert bool(got.faces.indicators.all())
    np.testing.assert_array_equal(got.faces.bboxes.numpy(), np.asarray(want.faces.bboxes))
    _close(got.faces.landmarks.numpy(), want.faces.landmarks)
    for name, out in want.attrs.items():
        for field, value in out._asdict().items():
            _close(getattr(got.attrs[name], field).numpy(), value)
    for field in ("clip_feats", "dino_feats", "face_feats"):
        _close(getattr(got, field).numpy(), getattr(want, field))


def test_train_debias_cli_on_converted_weights(tmp_path, tiny_towers, capsys):
    """`--model_dir` and `--guidance_dir` from the converters, one tiny step
    on the CPU: the CLIP and DINO terms are logged and finite."""
    tdir, _ = convert_both(tmp_path, *tiny_towers)
    sd = StableDiffusion(SDConfig.tiny(), device="cpu").init_random(0)
    chip_smoke.write_sd_checkpoint(sd, tmp_path / "sd")
    convert_sd.main(convert_sd.ConvertConfig(sd_dir=str(tmp_path / "sd"), out_dir=str(tmp_path / "store"),
                                             preset="tiny"))
    cfg = train_debias.parse_args([
        "--device", "cpu", "--tiny_smoke", "1", "--max_train_steps", "1", "--model_dir", str(tmp_path / "store"),
        "--guidance_dir", str(tdir), "--output_dir", str(tmp_path / "out")])
    trainer = train_debias.build_trainer(cfg)
    trainer.guidance = dataclasses.replace(trainer.guidance, chip_size=32, img_size_small=64)
    train_debias.main(cfg, trainer)
    out = capsys.readouterr().out
    assert f"[train] loaded {tmp_path / 'store'}" in out
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert [x["step"] for x in lines] == [1]
    assert lines[0]["face_rate"] == 1.0 and lines[0]["grads_finite"]
    assert all(np.isfinite(lines[0][k]) for k in ("train_loss", "train_loss_CLIP", "train_loss_DINO"))
