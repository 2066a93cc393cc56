"""fairdiff_torch's ONNX bridge against the JAX package's, graph by graph.

Every hand-built graph of tests/test_onnx_bridge.py (written there by its
own protobuf writer, as no `onnx` package is needed) goes through both bridges
on the same numpy inputs, fp32 on the CPU, within 1e-5; so do a graph that
runs the rest of the 38 op types, nearest resizes at SCRFD's x2 and at odd
sizes, `chip_smoke.scrfd_onnx` (the det_10g-shaped graph `[weights]` runs
at 640x640, here at 64x64) and `load_scrfd`, whose detections must be equal.
The parser is a copy, so it must decode every tensor alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fairdiff.guidance import faces as jfaces
from fairdiff.io import onnx_bridge as jb
from fairdiff.models.face_detector import FaceDetections as JDetections
from fairdiff_torch.guidance import faces as tfaces
from fairdiff_torch.io import onnx_bridge as tb
from test_onnx_bridge import (
    _scrfd_like_model,
    attr_f,
    attr_i,
    attr_ints,
    attr_s,
    lfield,
    model,
    node,
    sfield,
    tag,
    tensor_proto,
    vint,
)

torch.set_num_threads(1)

TOL = 1e-5


def run_both(data: bytes, feeds: dict[str, np.ndarray]):
    """-> ({name: JAX output}, {name: port output}) as numpy."""
    jfn, jp = jb.build_onnx_fn(jb.parse_onnx(data))
    want = jfn(jp, {k: jnp.asarray(v) for k, v in feeds.items()})
    tfn, tp = tb.build_onnx_fn(tb.parse_onnx(data))
    with torch.no_grad():
        got = tfn(tp, {k: torch.from_numpy(np.array(v)) for k, v in feeds.items()})
    to_np = lambda x: x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return {k: np.asarray(v) for k, v in want.items()}, {k: to_np(v) for k, v in got.items()}


def assert_same(data: bytes, feeds: dict[str, np.ndarray], exact: bool = False):
    want, got = run_both(data, feeds)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if exact or not np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)
    return got


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_conv_bn_prelu_maxpool_resize_sigmoid():
    rng = np.random.default_rng(0)
    inits = {
        "w": rng.normal(size=(4, 3, 3, 3)).astype(np.float32) * 0.3, "b": rng.normal(size=(4,)).astype(np.float32),
        "bn_s": rng.uniform(0.5, 1.5, 4).astype(np.float32), "bn_b": rng.normal(size=4).astype(np.float32),
        "bn_m": rng.normal(size=4).astype(np.float32), "bn_v": rng.uniform(0.5, 2.0, 4).astype(np.float32),
        "slope": rng.uniform(0.1, 0.3, 4).astype(np.float32), "scales": np.asarray([1.0, 1.0, 2.0, 2.0], np.float32),
    }
    data = model(
        nodes=[
            node("Conv", ["x", "w", "b"], ["c1"], attr_ints("strides", [1, 1]), attr_ints("pads", [1, 1, 1, 1]),
                 attr_ints("kernel_shape", [3, 3])),
            node("BatchNormalization", ["c1", "bn_s", "bn_b", "bn_m", "bn_v"], ["bn"], attr_f("epsilon", 1e-5)),
            node("PRelu", ["bn", "slope"], ["pr"]),
            node("MaxPool", ["pr"], ["mp"], attr_ints("kernel_shape", [2, 2]), attr_ints("strides", [2, 2])),
            node("Resize", ["mp", "", "scales"], ["rs"], attr_s("mode", "nearest")),
            node("Sigmoid", ["rs"], ["y"]),
        ],
        inits=inits, inputs=["x"], outputs=["y"],
    )
    assert_same(data, {"x": _x((2, 3, 8, 8), 1)})


def test_shape_subgraph_folds_to_numpy():
    data = model(
        nodes=[
            node("Shape", ["x"], ["shp"]),
            node("Gather", ["shp", "zero"], ["n"], attr_i("axis", 0)),
            node("Unsqueeze", ["n"], ["n1"], attr_ints("axes", [0])),
            node("Concat", ["n1", "rest"], ["target"], attr_i("axis", 0)),
            node("Reshape", ["x", "target"], ["y"]),
        ],
        inits={"zero": np.asarray(0, np.int64).reshape(()), "rest": np.asarray([-1, 3], np.int64)},
        inputs=["x"], outputs=["y", "target"],
    )
    got = assert_same(data, {"x": _x((2, 6, 4, 4), 2)}, exact=True)
    assert got["target"].tolist() == [2, -1, 3]


@pytest.mark.parametrize("trans_b", [0, 1])
def test_gemm_transposes_as_the_spec_says(trans_b):
    w = _x((2, 5) if trans_b else (5, 2), 3)
    attrs = [attr_i("transB", 1)] if trans_b else []
    data = model([node("Gemm", ["x", "w", "b"], ["y"], *attrs)], {"w": w, "b": _x((2,), 4)}, ["x"], ["y"])
    assert_same(data, {"x": _x((3, 5), 5)})


@pytest.mark.parametrize("include", [0, 1])
def test_average_pool_padding_counts(include):
    data = model([node("AveragePool", ["x"], ["y"], attr_ints("kernel_shape", [3, 3]), attr_ints("strides", [1, 1]),
                       attr_ints("pads", [1, 1, 1, 1]), *([attr_i("count_include_pad", 1)] if include else []))],
                 {}, ["x"], ["y"])
    assert_same(data, {"x": _x((1, 2, 5, 5), 6)})


@pytest.mark.parametrize("opset", [11, 13])
def test_softmax_axis_by_opset(opset):
    data = model([node("Softmax", ["x"], ["y"])], {}, ["x"], ["y"], opset=opset)
    assert tb.parse_onnx(data).opset == opset
    assert_same(data, {"x": _x((2, 3, 4), 7)})


@pytest.mark.parametrize("mode", ["SAME_UPPER", "SAME_LOWER"])
def test_conv_auto_pad(mode):
    data = model([node("Conv", ["x", "w"], ["y"], attr_ints("strides", [2, 2]), attr_ints("kernel_shape", [3, 3]),
                       attr_s("auto_pad", mode))], {"w": _x((3, 2, 3, 3), 8) * 0.3}, ["x"], ["y"])
    assert assert_same(data, {"x": _x((1, 2, 8, 8), 9)})["y"].shape == (1, 3, 4, 4)


def test_pool_auto_pad_same_upper():
    data = model([node("MaxPool", ["x"], ["y"], attr_ints("kernel_shape", [2, 2]), attr_ints("strides", [2, 2]),
                       attr_s("auto_pad", "SAME_UPPER"))], {}, ["x"], ["y"])
    assert assert_same(data, {"x": _x((1, 2, 7, 7), 10)})["y"].shape == (1, 2, 4, 4)


def test_constant_of_shape_expand_tile_range():
    float_one = np.asarray([1.0], np.float32)
    nodes = [
        node("Shape", ["x"], ["shp"]),
        node("ConstantOfShape", ["shp"], ["ones"], sfield(1, "value") + lfield(5, tensor_proto("", float_one))),
        node("Add", ["x", "ones"], ["y1"]),
        node("Expand", ["bias", "shp"], ["bias_e"]),
        node("Mul", ["x", "bias_e"], ["y2"]),
        node("Range", ["r0", "r4", "r1"], ["rng_v"]),
        node("Tile", ["rng_v", "reps"], ["y3"]),
    ]
    inits = {"bias": _x((3, 1), 11), "r0": np.asarray(0, np.int64), "r4": np.asarray(4, np.int64),
             "r1": np.asarray(1, np.int64), "reps": np.asarray([2], np.int64)}
    assert_same(model(nodes, inits, ["x"], ["y1", "y2", "y3"]), {"x": _x((2, 3, 4), 12)})


def test_the_other_op_types():
    """Relu, LeakyRelu, Exp, Clip, Sub, Div, Concat, GlobalAveragePool,
    Transpose, Flatten, MatMul, Gather, Unsqueeze and Squeeze on tensors,
    Cast, Constant, Identity, Dropout, Slice (a negative step too), Where,
    Upsample and a Tile of a tensor: each result an output."""
    nodes = [
        node("Relu", ["x"], ["relu"]),
        node("LeakyRelu", ["x"], ["leaky"], attr_f("alpha", 0.2)),
        node("Clip", ["x", "lo", "hi"], ["clip"]),
        node("Exp", ["clip"], ["exp"]),
        node("Sub", ["exp", "relu"], ["sub"]),
        node("Div", ["sub", "two"], ["div"]),
        node("Concat", ["relu", "leaky"], ["cat"], attr_i("axis", 1)),
        node("GlobalAveragePool", ["cat"], ["gap"]),
        node("Transpose", ["x"], ["tr"], attr_ints("perm", [0, 2, 3, 1])),
        node("Flatten", ["tr"], ["flat"], attr_i("axis", 1)),
        node("MatMul", ["flat", "mm"], ["mat"]),
        node("Gather", ["x", "idx"], ["gat"], attr_i("axis", 1)),
        node("Unsqueeze", ["mat"], ["uns"], attr_ints("axes", [1])),
        node("Squeeze", ["uns"], ["sq"], attr_ints("axes", [1])),
        node("Cast", ["x"], ["cast"], attr_i("to", 6)),
        node("Constant", [], ["const"], sfield(1, "value") + lfield(5, tensor_proto("", np.asarray([0.5], np.float32)))),
        node("Mul", ["x", "const"], ["scaled"]),
        node("Identity", ["scaled"], ["ident"]),
        node("Dropout", ["ident"], ["drop"]),
        node("Slice", ["x", "starts", "ends", "axes", "steps"], ["sl"]),
        node("Slice", ["x", "rstarts", "rends", "raxes", "rsteps"], ["rev"]),
        node("Where", ["mask", "x", "leaky"], ["where"]),
        node("Upsample", ["x", "up"], ["ups"], attr_s("mode", "nearest")),
        node("Tile", ["x", "reps"], ["tile"]),
    ]
    inits = {
        "lo": np.asarray(-0.5, np.float32), "hi": np.asarray(0.7, np.float32), "two": np.asarray(2.0, np.float32),
        "mm": _x((3 * 4 * 5, 6), 13), "idx": np.asarray([[2, 0], [1, -1]], np.int64),
        "starts": np.asarray([1, 0], np.int64), "ends": np.asarray([2**31 - 1, 3], np.int64),
        "axes": np.asarray([2, 3], np.int64), "steps": np.asarray([1, 2], np.int64),
        "rstarts": np.asarray([-1], np.int64), "rends": np.asarray([-(2**31)], np.int64),
        "raxes": np.asarray([3], np.int64), "rsteps": np.asarray([-2], np.int64),
        "mask": (np.random.default_rng(14).uniform(size=(1, 3, 4, 5)) > 0.5).astype(np.float32),
        "up": np.asarray([1.0, 1.0, 2.0, 3.0], np.float32), "reps": np.asarray([1, 2, 1, 1], np.int64),
    }
    outs = ["relu", "leaky", "clip", "exp", "div", "cat", "gap", "flat", "mat", "gat", "sq", "cast", "drop",
            "sl", "rev", "where", "ups", "tile"]
    data = model(nodes, inits, ["x"], outs)
    # Where takes a bool condition: recast the mask initializer's bytes
    graph_t, graph_j = tb.parse_onnx(data), jb.parse_onnx(data)
    for g in (graph_t, graph_j):
        g.initializers["mask"] = g.initializers["mask"].astype(bool)
    x = _x((2, 3, 4, 5), 15)
    jfn, jp = jb.build_onnx_fn(graph_j)
    tfn, tp = tb.build_onnx_fn(graph_t)
    want = jfn(jp, {"x": jnp.asarray(x)})
    with torch.no_grad():
        got = tfn(tp, {"x": torch.from_numpy(x)})
    for k in outs:
        g = got[k].numpy() if torch.is_tensor(got[k]) else np.asarray(got[k])
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("hw,out", [((10, 10), (20, 20)), ((5, 7), (9, 12)), ((9, 12), (5, 7))])
def test_nearest_resize_at_scrfd_and_odd_sizes(hw, out):
    """Resize by `sizes`: jax.image.resize's nearest rule (pixel centres),
    which is not F.interpolate's "nearest"; the odd sizes show it."""
    sizes = np.asarray([2, 3, *out], np.int64)
    data = model([node("Resize", ["x", "", "", "sizes"], ["y"], attr_s("mode", "nearest"))], {"sizes": sizes},
                 ["x"], ["y"])
    x = _x((2, 3, *hw), 16)
    got = assert_same(data, {"x": x}, exact=True)
    if hw == (5, 7):
        legacy = torch.nn.functional.interpolate(torch.from_numpy(x), size=out, mode="nearest").numpy()
        assert not np.array_equal(got["y"], legacy)


def test_tensor_decoding_matches_the_jax_parser():
    """The copied parser decodes double_data and fp16 bit patterns, and
    raises on external data, as the JAX one does."""
    vals = np.asarray([1.5, -2.25, 3.0], np.float64)
    buf = tag(1, 0) + vint(3) + tag(2, 0) + vint(11) + sfield(8, "dbl") + lfield(10, vals.tobytes())
    for parser in (jb, tb):
        name, arr = parser._tensor(buf)
        assert name == "dbl" and arr.dtype == np.float64
        np.testing.assert_array_equal(arr, vals)
    bits = np.asarray([1.0, -2.5, 0.0], np.float16).view(np.uint16)
    buf = tag(1, 0) + vint(3) + tag(2, 0) + vint(10) + sfield(8, "h") + lfield(5, b"".join(vint(int(b)) for b in bits))
    for parser in (jb, tb):
        np.testing.assert_array_equal(parser._tensor(buf)[1], np.asarray([1.0, -2.5, 0.0], np.float16))
    ext = tag(1, 0) + vint(4) + tag(2, 0) + vint(1) + sfield(8, "ext_w")
    ext += lfield(13, sfield(1, "location") + sfield(2, "weights.bin")) + tag(14, 0) + vint(1)
    with pytest.raises(NotImplementedError, match="ext_w.*external"):
        tb._tensor(ext)


def _detections_equal(got, want):
    np.testing.assert_array_equal(got.indicators.numpy(), np.asarray(want.indicators))
    for name in ("bboxes", "landmarks", "scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=TOL, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("graph", ["scrfd_like", "chip_smoke"])
def test_load_scrfd_matches_jax(tmp_path, graph):
    """Both bridges' `load_scrfd` on the same `.onnx` and images: the 9 raw
    outputs within 1e-5 and the selected faces equal. `chip_smoke.scrfd_onnx`
    (BatchNorm backbone, FPN with x2 nearest upsamples) detects on every
    lane by construction; the test file's graph at SCRFD's threshold on
    some."""
    size = {"scrfd_like": 32, "chip_smoke": 64}[graph]
    path = tmp_path / "det.onnx"
    path.write_bytes(_scrfd_like_model() if graph == "scrfd_like" else chip_smoke.scrfd_onnx(width=8, seed=3))
    images = np.random.default_rng(17).uniform(-1, 1, (3, 2 * size, 2 * size, 3)).astype(np.float32)
    jdetect, jparams = jb.load_scrfd(str(path), input_size=(size, size))
    tdetect, tparams = tb.load_scrfd(path, input_size=(size, size))
    want = jdetect(jparams, jnp.asarray(images))
    with torch.no_grad():
        got = tdetect(tparams, torch.from_numpy(images))
    _detections_equal(got, want)
    if graph == "chip_smoke":
        assert bool(got.indicators.all())
    x = jax.image.resize(jnp.asarray(images), (3, size, size, 3), "bilinear")
    x = np.asarray((x[..., ::-1] * (127.5 / 128.0)).transpose(0, 3, 1, 2))
    jraw, traw = run_both(path.read_bytes(), {tb.parse_onnx(str(path)).inputs[0]: x})
    for k in jraw:
        np.testing.assert_allclose(traw[k], jraw[k], rtol=TOL, atol=TOL, err_msg=k)


def test_scrfd_feed_follows_a_cast_weight_tree(tmp_path):
    """Weights cast to bf16 take a bf16 feed (conv takes one dtype), as in
    the JAX bridge: the faces found equal JAX's on the test file's graph;
    `chip_smoke.scrfd_onnx` (whose BatchNorm the JAX bridge cannot run on
    bf16 numpy weights) runs in bf16 and still finds every face."""
    path = tmp_path / "det.onnx"
    path.write_bytes(_scrfd_like_model())
    images = np.random.default_rng(18).uniform(-1, 1, (2, 48, 48, 3)).astype(np.float32)
    jdetect, jparams = jb.load_scrfd(str(path), input_size=(32, 32))
    tdetect, tparams = tb.load_scrfd(path, input_size=(32, 32))
    jbf = jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16), jparams)
    want = jdetect(jbf, jnp.asarray(images))
    with torch.no_grad():
        got = tdetect({k: v.bfloat16() for k, v in tparams.items()}, torch.from_numpy(images))
    np.testing.assert_array_equal(got.indicators.numpy(), np.asarray(want.indicators))
    path.write_bytes(chip_smoke.scrfd_onnx(width=8, seed=4))
    tdetect, tparams = tb.load_scrfd(path, input_size=(64, 64))
    with torch.no_grad():
        got = tdetect({k: v.bfloat16() for k, v in tparams.items()}, torch.from_numpy(images))
    assert bool(got.indicators.all())


def test_compose_detect_fns_follows_the_jax_merge():
    """Lanes the primary misses come from the fallback, on both sides."""
    rng = np.random.default_rng(19)

    def dets(ind):
        return dict(indicators=np.asarray(ind), bboxes=rng.normal(size=(4, 4)).astype(np.float32),
                    landmarks=rng.normal(size=(4, 5, 2)).astype(np.float32),
                    scores=rng.uniform(size=4).astype(np.float32))

    a, b = dets([True, False, False, True]), dets([False, True, False, True])
    jdet = lambda d: JDetections(**{k: jnp.asarray(v) for k, v in d.items()})
    tdet = lambda d: tfaces.FaceDetections(**{k: torch.from_numpy(v) for k, v in d.items()})
    want = jfaces.compose_detect_fns(lambda p, x: jdet(p), lambda p, x: jdet(p))({"primary": a, "fallback": b}, None)
    got = tfaces.compose_detect_fns(lambda p, x: tdet(p), lambda p, x: tdet(p))({"primary": a, "fallback": b}, None)
    closure = tfaces.compose_detectors(lambda x: tdet(a), lambda x: tdet(b))(None)
    for out in (got, closure):
        for name in ("indicators", "bboxes", "landmarks", "scores"):
            np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    assert got.indicators.tolist() == [True, True, False, True]
    np.testing.assert_array_equal(got.bboxes[1].numpy(), b["bboxes"][1])
    np.testing.assert_array_equal(got.bboxes[3].numpy(), a["bboxes"][3])
