"""Weight conversion for the frozen feature models, CLIP vision and DINOv2
(a copy of fairdiff/io/feature_models.py): HF layouts -> parameter trees."""

from __future__ import annotations

from typing import Any

from fairdiff_torch.io import torch_convert as tc


def convert_clip_vision(sd: tc.Tensors, num_layers: int) -> dict:
    """HF `CLIPVisionModelWithProjection.state_dict()` -> CLIPVisionModel
    params."""
    proj = tc.linear(sd, "visual_projection", bias=False)
    if any(k.startswith("vision_model.") for k in sd):
        sd = {k.removeprefix("vision_model."): v for k, v in sd.items()}
    params: dict[str, Any] = {
        "class_embedding": tc._np(sd["embeddings.class_embedding"]),
        "patch_embedding": {
            "kernel": tc._np(sd["embeddings.patch_embedding.weight"]).transpose(2, 3, 1, 0)
        },
        "position_embedding": tc._np(sd["embeddings.position_embedding.weight"]),
        "pre_layrnorm": tc.norm(sd, "pre_layrnorm"),
        "post_layernorm": tc.norm(sd, "post_layernorm"),
        "visual_projection": proj,
    }
    for i in range(num_layers):
        p = f"encoder.layers.{i}"
        params[f"layers_{i}"] = {
            "layer_norm1": tc.norm(sd, f"{p}.layer_norm1"),
            "layer_norm2": tc.norm(sd, f"{p}.layer_norm2"),
            "self_attn": {
                name: tc.linear(sd, f"{p}.self_attn.{name}")
                for name in ("q_proj", "k_proj", "v_proj", "out_proj")
            },
            "mlp": {
                "fc1": tc.linear(sd, f"{p}.mlp.fc1"),
                "fc2": tc.linear(sd, f"{p}.mlp.fc2"),
            },
        }
    return params


def convert_dinov2(sd: tc.Tensors, num_layers: int) -> dict:
    """HF `Dinov2Model.state_dict()` (same tensor layout as the torch.hub
    dinov2 checkpoints) -> DINOv2Model params."""
    params: dict[str, Any] = {
        "cls_token": tc._np(sd["embeddings.cls_token"]),
        "position_embeddings": tc._np(sd["embeddings.position_embeddings"])[0],
        "patch_embedding": {
            "kernel": tc._np(
                sd["embeddings.patch_embeddings.projection.weight"]
            ).transpose(2, 3, 1, 0),
            "bias": tc._np(sd["embeddings.patch_embeddings.projection.bias"]),
        },
        "norm": tc.norm(sd, "layernorm"),
    }
    for i in range(num_layers):
        p = f"encoder.layer.{i}"
        params[f"layers_{i}"] = {
            "norm1": tc.norm(sd, f"{p}.norm1"),
            "norm2": tc.norm(sd, f"{p}.norm2"),
            "attention": {
                "q_proj": tc.linear(sd, f"{p}.attention.attention.query"),
                "k_proj": tc.linear(sd, f"{p}.attention.attention.key"),
                "v_proj": tc.linear(sd, f"{p}.attention.attention.value"),
                "out_proj": tc.linear(sd, f"{p}.attention.output.dense"),
            },
            "mlp": {
                "fc1": tc.linear(sd, f"{p}.mlp.fc1"),
                "fc2": tc.linear(sd, f"{p}.mlp.fc2"),
            },
            "layer_scale1": tc._np(sd[f"{p}.layer_scale1.lambda1"]),
            "layer_scale2": tc._np(sd[f"{p}.layer_scale2.lambda1"]),
        }
    return params
