"""The port's checkpoint converters and safetensors reader against the JAX
package's converters and the `safetensors` package.

Each converter gets the same seeded state dict in the reference's external
layout on both sides and must give the same tree exactly (both are numpy
remaps, so the tolerance is 0): the diffusers UNet and VAE (tests/torch_refs.py,
the VAE in both attention namings and the old 1x1-conv form), transformers'
CLIP text, CLIP vision and DINOv2, torchvision's MobileNetV3 and
opensphere's SFNet (the layouts tests/test_weights_pipeline_e2e.py writes).
The safetensors reader equals the package on every dtype tried. Last, one
tiny SD directory converted by both packages from the same files runs
through the JAX text encoder, UNet and VAE and the port's, fp32 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from fairdiff.io import classifiers as jcls
from fairdiff.io import feature_models as jfm
from fairdiff.io import sd_loader as jsd
from fairdiff.io import torch_convert as jtc
from fairdiff.models import sfnet as jsfnet
from fairdiff.sampling import pipeline as jpipe
from fairdiff.tools import convert_sd as jconvert_sd
from fairdiff_torch.io import classifiers as tcls
from fairdiff_torch.io import feature_models as tfm
from fairdiff_torch.io import safetensors as tst
from fairdiff_torch.io import sd_loader as tsd
from fairdiff_torch.io import torch_convert as ttc
from fairdiff_torch.models import sfnet as tsfnet
from fairdiff_torch.sampling import pipeline as tpipe
from fairdiff_torch.tools import convert_sd as tconvert_sd
from test_torch_models import rel_err
from test_weights_pipeline_e2e import _write_mobilenet_pt, _write_sfnet_pth
from torch_refs import TUNet, TVAE

torch.set_num_threads(1)

JCFG = jpipe.SDConfig.tiny()
TCFG = tpipe.SDConfig.tiny()


def _seeded(module: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """The module's state dict with every float tensor drawn from a numpy
    seed: matrices and kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2),
    biases N(0, 0.1^2) (none 0 or 1, so a swapped leaf shows)."""
    rng = np.random.default_rng(seed)

    def draw(name, v):
        shape = tuple(v.shape)
        if v.dim() >= 2:
            x = rng.normal(size=shape) * (v[0].numel() ** -0.5)
        elif name.endswith("weight"):
            x = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            x = 0.1 * rng.normal(size=shape)
        return torch.from_numpy(x.astype(np.float32))

    return {k: draw(k, v) if v.is_floating_point() else v for k, v in module.state_dict().items()}


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) and isinstance(want, dict), path
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.shape == w.shape, f"{path}/{k}"
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")


def _hf_text(cfg) -> transformers.CLIPTextModel:
    return transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers, num_attention_heads=cfg.num_attention_heads,
        max_position_embeddings=cfg.max_position_embeddings, hidden_act=cfg.hidden_act,
        eos_token_id=cfg.eos_token_id, bos_token_id=0))


def test_convert_unet_matches_jax():
    sd = _seeded(TUNet(JCFG.unet), seed=0)
    assert_trees_equal(tsd.convert_unet(sd, TCFG.unet), jsd.convert_unet(_numpy(sd), JCFG.unet))


def _vae_layout(sd: dict, form: str) -> dict:
    """diffusers' VAE mid-attention as `form` names it: "modern"
    (to_q/to_k/to_v/to_out.0), "legacy" (query/key/value/proj_attn) or
    "conv1x1" (legacy names, weights stored as 1x1 convolutions)."""
    if form == "modern":
        return sd
    names = {"to_q.": "query.", "to_k.": "key.", "to_v.": "value.", "to_out.0.": "proj_attn."}
    out = {}
    for k, v in sd.items():
        if ".mid_block.attentions.0." in k:
            for new, old in names.items():
                k = k.replace(f".attentions.0.{new}", f".attentions.0.{old}")
            if form == "conv1x1" and k.endswith(".weight") and v.ndim == 2:
                v = v[:, :, None, None]
        out[k] = v
    return out


@pytest.mark.parametrize("form", ["modern", "legacy", "conv1x1"])
def test_convert_vae_matches_jax(form):
    sd = _vae_layout(_seeded(TVAE(JCFG.vae), seed=1), form)
    if form != "modern":
        assert any("proj_attn" in k for k in sd)
    got = tsd.convert_vae(sd, TCFG.vae)
    assert_trees_equal(got, jsd.convert_vae(_numpy(sd), JCFG.vae))
    modern = tsd.convert_vae(_seeded(TVAE(JCFG.vae), seed=1), TCFG.vae)
    assert_trees_equal(got, modern)  # every form gives the same tree


def test_convert_clip_text_matches_jax():
    sd = _seeded(_hf_text(JCFG.text), seed=2)
    n = JCFG.text.num_hidden_layers
    assert_trees_equal(ttc.convert_clip_text(sd, n), jtc.convert_clip_text(_numpy(sd), n))


def test_convert_clip_vision_matches_jax():
    hf = transformers.CLIPVisionModelWithProjection(transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4, image_size=28,
        patch_size=14, projection_dim=16, hidden_act="gelu"))
    sd = _seeded(hf, seed=3)
    assert_trees_equal(tfm.convert_clip_vision(sd, 2), jfm.convert_clip_vision(_numpy(sd), 2))


def test_convert_dinov2_matches_jax():
    hf = transformers.Dinov2Model(transformers.Dinov2Config(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4, image_size=56,
        patch_size=14))
    sd = _seeded(hf, seed=4)
    assert_trees_equal(tfm.convert_dinov2(sd, 2), jfm.convert_dinov2(_numpy(sd), 2))


def test_convert_mobilenet_v3_matches_jax(tmp_path):
    sd = torch.load(_write_mobilenet_pt(tmp_path / "m.pt", 80), weights_only=True)
    assert_trees_equal(tcls.convert_mobilenet_v3(sd), jcls.convert_mobilenet_v3(_numpy(sd)))


@pytest.mark.parametrize("variant", ["sfnet20_deprecated", "sfnet20"])
def test_convert_sfnet_matches_jax(tmp_path, variant):
    sd = torch.load(_write_sfnet_pth(tmp_path / "s.pth"), weights_only=True)
    got = tsfnet.convert_sfnet(sd, tsfnet.SFNetConfig.for_variant(variant))
    assert_trees_equal(got, jsfnet.convert_sfnet(_numpy(sd), jsfnet.SFNetConfig.for_variant(variant)))


def test_bf16_tensors_convert_exactly():
    """A bf16 state dict (numpy has no bfloat16) converts to the fp32 tree
    of the same values."""
    sd = _seeded(_hf_text(JCFG.text), seed=5)
    bf16 = {k: v.bfloat16() if v.is_floating_point() else v for k, v in sd.items()}
    widened = {k: v.float() if v.is_floating_point() else v for k, v in bf16.items()}
    n = JCFG.text.num_hidden_layers
    assert_trees_equal(ttc.convert_clip_text(bf16, n), jtc.convert_clip_text(_numpy(widened), n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    """Mixed dtypes in one file (so later tensors start at offsets that are
    not multiples of their size), a scalar, an empty tensor and metadata."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    rng = np.random.default_rng(6)
    make = lambda shape: (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
                          if dtype.is_floating_point else torch.from_numpy(rng.integers(-9, 9, size=shape)).to(dtype))
    tensors = {"w.odd": torch.ones(3, dtype=torch.int8), "layer.weight": make((4, 3)),
               "layer.bias": make((5,)), "scalar": make(()), "empty": make((0, 2)),
               "z.f16": torch.arange(3, dtype=torch.float16)}
    path = tmp_path / "x.safetensors"
    save_file(tensors, path, metadata={"format": "pt", "note": "seeded"})
    got = tst.load_file(path)
    with safe_open(path, "pt") as f:
        want = {k: f.get_tensor(k) for k in f.keys()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    header, _ = tst.read_header(path)
    assert header["__metadata__"] == {"format": "pt", "note": "seeded"}


def _write_tiny_sd(root):
    """A tiny diffusers-layout directory: the UNet as `.safetensors`, the
    VAE and text encoder as torch `.bin`."""
    from safetensors.torch import save_file

    torch.manual_seed(0)
    parts = {"unet": _seeded(TUNet(JCFG.unet), 7), "vae": _seeded(TVAE(JCFG.vae), 8),
             "text_encoder": _seeded(_hf_text(JCFG.text), 9)}
    for name, sd in parts.items():
        (root / name).mkdir(parents=True)
    save_file(parts["unet"], root / "unet" / "diffusion_pytorch_model.safetensors")
    torch.save(parts["vae"], root / "vae" / "diffusion_pytorch_model.bin")
    torch.save(parts["text_encoder"], root / "text_encoder" / "pytorch_model.bin")
    return root


def test_load_state_dict_reads_safetensors_first_then_bin(tmp_path):
    from safetensors.torch import save_file

    a = {"x": torch.ones(2)}
    torch.save({"x": torch.zeros(2), "y": torch.ones(1)}, tmp_path / "model.bin")
    save_file(a, tmp_path / "model.safetensors")
    got = tconvert_sd.load_state_dict(tmp_path)
    assert list(got) == ["x"] and torch.equal(got["x"], a["x"])
    (tmp_path / "model.safetensors").unlink()
    want = jconvert_sd.load_state_dict(tmp_path)
    got = tconvert_sd.load_state_dict(tmp_path)
    assert sorted(got) == sorted(want) and all(np.array_equal(got[k].numpy(), want[k]) for k in want)
    with pytest.raises(FileNotFoundError):
        tconvert_sd.load_state_dict(tmp_path / "missing")


def test_tiny_sd_converted_by_both_packages_runs_alike(tmp_path):
    """The same files through each package's reader and converters, then
    through each package's models: text encoder, one CFG-shaped UNet call and
    a VAE decode, fp32 on the CPU, within 1e-5 relative L2 (summation order
    only)."""
    sd_dir = _write_tiny_sd(tmp_path / "sd")
    params = {
        "text_encoder": jtc.convert_clip_text(jconvert_sd.load_state_dict(sd_dir / "text_encoder"),
                                              JCFG.text.num_hidden_layers),
        "unet": jsd.convert_unet(jconvert_sd.load_state_dict(sd_dir / "unet"), JCFG.unet),
        "vae": jsd.convert_vae(jconvert_sd.load_state_dict(sd_dir / "vae"), JCFG.vae),
    }
    tconvert_sd.main(tconvert_sd.ConvertConfig(sd_dir=str(sd_dir), out_dir=str(tmp_path / "store"), preset="tiny"))
    tsd_ = tpipe.StableDiffusion(TCFG, device="cpu").load_params(tmp_path / "store")
    jsd_ = jpipe.StableDiffusion(JCFG)

    rng = np.random.default_rng(10)
    ids = np.array([[0, 5, 6, 7] + [63] * 12, [0, 63] + [63] * 14], np.int32)
    ctx_j = jsd_.text_encoder.apply({"params": params["text_encoder"]}, jnp.asarray(ids))["last_hidden_state"]
    with torch.no_grad():
        ctx_t = tsd_.text_encoder(torch.from_numpy(ids).long())["last_hidden_state"]
    assert rel_err(ctx_t.numpy(), np.asarray(ctx_j)) < 1e-5

    lat = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    t = np.array([999, 17], np.int32)
    eps_j = jsd_.unet.apply({"params": params["unet"]}, jnp.asarray(lat), jnp.asarray(t), ctx_j)
    with torch.no_grad():
        eps_t = tsd_.unet(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(np.array(ctx_j)))
    assert rel_err(eps_t.numpy(), np.asarray(eps_j)) < 1e-5

    img_j = jsd_.vae.apply({"params": params["vae"]}, jnp.asarray(lat), method=jsd_.vae.decode)
    with torch.no_grad():
        img_t = tsd_.vae.decode(torch.from_numpy(lat))
    assert rel_err(img_t.numpy(), np.asarray(img_j)) < 1e-5
