"""Runtime-independent ONNX bridge on torch ops: the reference's SCRFD face
detector without onnxruntime (counterpart of fairdiff/io/onnx_bridge.py).

The reference's primary face detector is insightface's SCRFD ("buffalo_l"
det_10g.onnx) run through onnxruntime. This module runs the same graph:

  1. a pure-Python protobuf wire-format parser for ONNX ModelProto (a copy
     of the JAX package's; no onnx, onnxruntime or protoc is needed);
  2. a small interpreter that executes the graph's inference op set with
     torch ops (`F.conv2d`, `torch.matmul`, pooling, elementwise), batched,
     on the device of its weights;
  3. an SCRFD head adapter mapping the graph's 9 outputs (3 strides x
     score/bbox/kps) onto `models.face_detector.decode_detections`.

Shape-dependent subgraphs (Shape -> Gather -> Concat -> Reshape chains) are
folded to numpy constants as they run: every tensor derived only from
shapes and constants stays a numpy array, and only what depends on the
input is a torch tensor.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fairdiff_torch.models.face_detector import DetectorConfig, decode_detections, select_largest_face
from fairdiff_torch.utils.resize import resize

# --------------------------------------------------------------------------
# protobuf wire format
# --------------------------------------------------------------------------


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message's fields."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _packed_varints(buf: bytes) -> list[int]:
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _varint(buf, pos)
        out.append(v)
    return out


def _signed(v: int) -> int:
    """Interpret a varint as two's-complement int64 (protobuf int64)."""
    return v - (1 << 64) if v >= (1 << 63) else v


_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _tensor(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    dtype = np.float32
    name = ""
    raw: Optional[bytes] = None
    float_data: list[float] = []
    int_data: list[int] = []
    external = False
    for field, wire, val in _fields(buf):
        if field == 1:  # dims
            dims += _packed_varints(val) if wire == 2 else [val]
        elif field == 2:
            dtype = _DTYPES[val]
        elif field == 4:  # float_data (packed)
            float_data += list(np.frombuffer(val, "<f4"))
        elif field in (5, 7, 11):  # int32/int64/uint64_data (packed varints)
            int_data += [_signed(v) for v in _packed_varints(val)]
        elif field == 6:  # string_data
            raise NotImplementedError(
                "ONNX string tensors are not supported by the bridge"
            )
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
        elif field == 10:  # double_data (packed fixed64)
            float_data += list(np.frombuffer(val, "<f8"))
        elif field in (13, 14):  # external_data / data_location
            # field 14 appears only when EXTERNAL (default 0 is omitted)
            external = True
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype).reshape(dims).copy()
    elif float_data:
        arr = np.asarray(float_data, dtype=dtype).reshape(dims)
    elif int_data:
        if dtype == np.float16:
            # spec: fp16 values without raw_data live in int32_data as
            # uint16 BIT PATTERNS (1.0 -> 15360), not numeric values
            arr = (
                np.asarray(int_data, np.uint16)
                .view(np.float16)
                .reshape(dims)
            )
        else:
            arr = np.asarray(int_data, dtype=dtype).reshape(dims)
    elif int(np.prod(dims)) == 0:
        arr = np.zeros(dims, dtype=dtype)
    else:
        # never fabricate zero weights for data we failed to decode —
        # a detector that silently scores everything 0.5 is worse than
        # an error naming the tensor
        raise NotImplementedError(
            f"ONNX initializer {name!r} ({dims}, {np.dtype(dtype).name}) has "
            + ("externally-stored data (save the model with all tensors "
               "inline: onnx.save(..., save_as_external_data=False) or "
               "convert_external_data_to_raw_data)" if external
               else "no inline data in a storage field this parser knows")
        )
    return name, arr


def _attribute(buf: bytes) -> tuple[str, Any]:
    name = ""
    value: Any = None
    ints: list[int] = []
    floats: list[float] = []
    strings: list[bytes] = []
    for field, wire, val in _fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:  # f
            value = struct.unpack("<f", val)[0]
        elif field == 3:  # i
            value = _signed(val)
        elif field == 4:  # s
            value = val.decode(errors="replace")
        elif field == 5:  # t
            value = _tensor(val)[1]
        elif field == 7:  # floats
            floats += (
                list(np.frombuffer(val, "<f4")) if wire == 2
                else [struct.unpack("<f", val)[0]]
            )
        elif field == 8:  # ints
            ints += (
                [_signed(v) for v in _packed_varints(val)]
                if wire == 2 else [_signed(val)]
            )
        elif field == 9:
            strings.append(val)
    if ints:
        value = ints
    elif floats:
        value = floats
    elif strings:
        value = [s.decode(errors="replace") for s in strings]
    return name, value


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, Any]
    name: str = ""


@dataclasses.dataclass
class OnnxGraph:
    nodes: list[OnnxNode]
    initializers: dict[str, np.ndarray]
    inputs: list[str]  # graph inputs that are NOT initializers
    outputs: list[str]
    # default-domain ai.onnx opset version (ops change spec defaults across
    # opsets — e.g. Softmax axis semantics changed at 13)
    opset: int = 13


def _value_info_name(buf: bytes) -> str:
    for field, _, val in _fields(buf):
        if field == 1:
            return val.decode()
    return ""


def _graph(buf: bytes) -> OnnxGraph:
    nodes: list[OnnxNode] = []
    inits: dict[str, np.ndarray] = {}
    inputs: list[str] = []
    outputs: list[str] = []
    for field, _, val in _fields(buf):
        if field == 1:  # node
            op_type, nname = "", ""
            nin: list[str] = []
            nout: list[str] = []
            attrs: dict[str, Any] = {}
            for f2, _, v2 in _fields(val):
                if f2 == 1:
                    nin.append(v2.decode())
                elif f2 == 2:
                    nout.append(v2.decode())
                elif f2 == 3:
                    nname = v2.decode()
                elif f2 == 4:
                    op_type = v2.decode()
                elif f2 == 5:
                    k, v = _attribute(v2)
                    attrs[k] = v
            nodes.append(OnnxNode(op_type, nin, nout, attrs, nname))
        elif field == 5:  # initializer
            name, arr = _tensor(val)
            inits[name] = arr
        elif field == 11:
            inputs.append(_value_info_name(val))
        elif field == 12:
            outputs.append(_value_info_name(val))
    inputs = [i for i in inputs if i not in inits]
    return OnnxGraph(nodes, inits, inputs, outputs)


def parse_onnx(data: bytes | str) -> OnnxGraph:
    """ONNX ModelProto bytes (or file path) -> OnnxGraph."""
    if isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    graph: Optional[OnnxGraph] = None
    opset: Optional[int] = None
    for field, _, val in _fields(data):
        if field == 7:  # ModelProto.graph
            graph = _graph(val)
        elif field == 8:  # ModelProto.opset_import (OperatorSetIdProto)
            domain, version = "", None
            for f2, _, v2 in _fields(val):
                if f2 == 1:
                    domain = v2.decode()
                elif f2 == 2:
                    version = v2
            if domain in ("", "ai.onnx") and version is not None:
                opset = int(version)
    if graph is None:
        raise ValueError("no graph found in ONNX model")
    if opset is not None:
        graph.opset = opset
    return graph


# --------------------------------------------------------------------------
# interpreter
# --------------------------------------------------------------------------


def _pair(v, default):
    if v is None:
        return (default, default)
    return tuple(v[-2:]) if len(v) >= 2 else (v[0], v[0])


def _auto_pads(in_hw, ks, strides, dil, mode):
    """Explicit per-dim (lo, hi) pads for ONNX auto_pad SAME_UPPER/LOWER:
    output size = ceil(in/stride); the odd padding unit goes at the END
    for SAME_UPPER (== XLA "SAME") and at the START for SAME_LOWER."""
    out = []
    for size, k, s, d in zip(in_hw, ks, strides, dil):
        eff_k = (k - 1) * d + 1
        total = max((-(-size // s) - 1) * s + eff_k - size, 0)
        half, odd = divmod(total, 2)
        out.append((half + odd, half) if mode == "SAME_LOWER"
                   else (half, half + odd))
    return out



def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _tensor_of(x, device: torch.device) -> torch.Tensor:
    """A static operand as a tensor on `device`, float64 as float32 (the
    JAX bridge runs without 64-bit floats)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.ascontiguousarray(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=device)


def _operands(xs: list) -> list:
    """Every operand a tensor when any of them is one."""
    like = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    return [x if like is None or x is None else _tensor_of(x, like.device) for x in xs]


def _pads_nchw(padding) -> tuple[int, ...]:
    """[(top, bottom), (left, right)] -> F.pad's (left, right, top, bottom)."""
    (t, b), (l, r) = padding
    return (l, r, t, b)


def _conv(x, w, b, attrs):
    strides = _pair(attrs.get("strides"), 1)
    dil = _pair(attrs.get("dilations"), 1)
    groups = int(attrs.get("group", 1))
    pads = attrs.get("pads")
    auto = attrs.get("auto_pad", "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        padding = _auto_pads(x.shape[2:], w.shape[2:], strides, dil, auto)
    elif pads is None:
        padding = [(0, 0), (0, 0)]
    else:  # onnx order: [top, left, bottom, right]
        padding = [(pads[0], pads[2]), (pads[1], pads[3])]
    (t, bottom), (left, r) = padding
    if (t, left) != (bottom, r):
        x, t, left = F.pad(x, _pads_nchw(padding)), 0, 0
    return F.conv2d(x, w, b, stride=strides, padding=(t, left), dilation=dil, groups=groups)


def _pool(x, attrs, kind):
    ks = _pair(attrs.get("kernel_shape"), 1)
    strides = _pair(attrs.get("strides"), 1)
    pads = attrs.get("pads")
    auto = attrs.get("auto_pad", "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        padding = _auto_pads(x.shape[2:], ks, strides, (1, 1), auto)
    else:
        padding = [(pads[0], pads[2]), (pads[1], pads[3])] if pads else [(0, 0), (0, 0)]
    pad = _pads_nchw(padding)
    if kind == "max":
        return F.max_pool2d(F.pad(x, pad, value=-torch.inf), ks, strides)
    s = F.avg_pool2d(F.pad(x, pad), ks, strides)
    if attrs.get("count_include_pad", 0):
        return s
    # spec default count_include_pad=0: each output averages only the
    # in-bounds samples of its window, so border divisors shrink
    counts = F.avg_pool2d(F.pad(torch.ones_like(x[:1, :1]), pad), ks, strides)
    return s / counts


def _resize_nearest(x, out_hw):
    n, c, _, _ = x.shape
    return resize(x, (n, c, out_hw[0], out_hw[1]), "nearest")


def _is_static(x) -> bool:
    return isinstance(x, np.ndarray) or np.isscalar(x)


def _ints(x) -> list[int]:
    return [int(v) for v in np.asarray(x).reshape(-1)]


def _slice_axis(x, ax: int, s: int, e: Optional[int], st: int):
    if st > 0 or _is_static(x):
        sl = [slice(None)] * x.ndim
        sl[ax] = slice(s, e, st)
        return x[tuple(sl)]
    # torch slicing takes no negative step
    idx = np.arange(x.shape[ax])[slice(s, e, st)]
    return x.index_select(ax, torch.as_tensor(idx.copy(), device=x.device))


_BINARY = {"Add": (np.add, torch.add), "Sub": (np.subtract, torch.sub),
           "Mul": (np.multiply, torch.mul), "Div": (np.divide, torch.div)}


def build_onnx_fn(
    graph: OnnxGraph,
) -> tuple[Callable[[dict, dict], dict], dict[str, torch.Tensor]]:
    """-> (fn(params, feeds) -> {output_name: tensor}, params).

    `params` holds the graph's weights as CPU tensors (move them with the
    feeds). `feeds` maps graph input names to tensors. Initializers consumed
    in shape-semantic positions (Reshape targets, Resize scales/sizes, Slice
    bounds, axes, indices, Clip limits), and what is computed from them and
    from shapes, stay numpy constants.
    """
    _STATIC_POS = {
        "Reshape": (1,), "Resize": (1, 2, 3), "Upsample": (1,),
        "Slice": (1, 2, 3, 4), "Unsqueeze": (1,), "Squeeze": (1,),
        "Gather": (1,), "Clip": (1, 2), "Expand": (1,), "Tile": (1,),
        "ConstantOfShape": (0,), "Range": (0, 1, 2),
    }
    # names needed as concrete values, closed backwards through their
    # producing subgraph (stopping at Shape, whose output is always concrete)
    needed: set[str] = set()
    for node in graph.nodes:
        for pos in _STATIC_POS.get(node.op_type, ()):
            if pos < len(node.inputs) and node.inputs[pos]:
                needed.add(node.inputs[pos])
    producers = {o: n for n in graph.nodes for o in n.outputs if o}
    stack = list(needed)
    while stack:
        name = stack.pop()
        prod = producers.get(name)
        if prod is None or prod.op_type == "Shape":
            continue
        for inp in prod.inputs:
            if inp and inp not in needed:
                needed.add(inp)
                stack.append(inp)
    static_names = needed & set(graph.initializers)
    static_consts = {k: graph.initializers[k] for k in static_names}
    params = {
        k: _tensor_of(v, torch.device("cpu")) for k, v in graph.initializers.items() if k not in static_names
    }

    def fn(p: dict, feeds: dict) -> dict:
        env: dict[str, Any] = {}
        env.update(static_consts)
        env.update(p)
        env.update(feeds)

        def get(name):
            return env[name] if name else None

        for node in graph.nodes:
            i = [get(n) for n in node.inputs]
            a = node.attrs
            op = node.op_type
            if op == "Conv":
                out = _conv(i[0], i[1], i[2] if len(i) > 2 else None, a)
            elif op == "BatchNormalization":
                scale, bias, mean, var = i[1], i[2], i[3], i[4]
                eps = a.get("epsilon", 1e-5)
                sh = (1, -1, 1, 1)
                out = (i[0] - mean.reshape(sh)) * (
                    scale.reshape(sh) / torch.sqrt(var + eps).reshape(sh)
                ) + bias.reshape(sh)
            elif op == "Relu":
                out = F.relu(i[0])
            elif op == "PRelu":
                slope = _tensor_of(i[1], i[0].device)
                if slope.ndim == 1 and i[0].ndim == 4:
                    slope = slope.reshape(1, -1, 1, 1)
                out = torch.where(i[0] >= 0, i[0], i[0] * slope)
            elif op == "LeakyRelu":
                out = F.leaky_relu(i[0], a.get("alpha", 0.01))
            elif op == "Sigmoid":
                out = torch.sigmoid(i[0])
            elif op == "Softmax":
                if graph.opset >= 13:
                    out = torch.softmax(i[0], dim=a.get("axis", -1))
                else:
                    # opset<13 semantics: flatten to 2D at `axis` (default
                    # 1) and normalize over the trailing block
                    ax = a.get("axis", 1) % max(i[0].ndim, 1)
                    lead = int(np.prod(i[0].shape[:ax]))
                    flat = i[0].reshape(lead, -1)
                    out = torch.softmax(flat, dim=-1).reshape(i[0].shape)
            elif op == "Exp":
                out = torch.exp(i[0])
            elif op == "Clip":
                lo = i[1] if len(i) > 1 and i[1] is not None else a.get("min")
                hi = i[2] if len(i) > 2 and i[2] is not None else a.get("max")
                out = torch.clamp(i[0], None if lo is None else float(np.asarray(lo)),
                                  None if hi is None else float(np.asarray(hi)))
            elif op in _BINARY:
                np_op, torch_op = _BINARY[op]
                if _is_static(i[0]) and _is_static(i[1]):
                    out = np_op(i[0], i[1])
                else:
                    out = torch_op(*_operands(i[:2]))
            elif op == "Concat":
                ax = a["axis"] if not isinstance(a["axis"], list) else a["axis"][0]
                if all(_is_static(x) for x in i):
                    out = np.concatenate([np.atleast_1d(x) for x in i], axis=ax)
                else:
                    out = torch.cat(_operands(i), dim=ax)
            elif op == "MaxPool":
                out = _pool(i[0], a, "max")
            elif op == "AveragePool":
                out = _pool(i[0], a, "avg")
            elif op == "GlobalAveragePool":
                out = i[0].mean(dim=(2, 3), keepdim=True)
            elif op == "Reshape":
                shape = _ints(i[1])
                shape = [i[0].shape[k] if s == 0 else s for k, s in enumerate(shape)]
                out = i[0].reshape(shape)
            elif op == "Transpose":
                perm = a["perm"]
                out = i[0].transpose(perm) if _is_static(i[0]) else i[0].permute(perm)
            elif op == "Flatten":
                ax = a.get("axis", 1)
                out = i[0].reshape(int(np.prod(i[0].shape[:ax])), -1)
            elif op == "Gemm":
                x, w = _operands(i[:2])
                if a.get("transA", 0):
                    x = x.T
                if a.get("transB", 0):  # spec default 0 (B as stored)
                    w = w.T
                out = a.get("alpha", 1.0) * (x @ w)
                if len(i) > 2 and i[2] is not None:
                    out = out + a.get("beta", 1.0) * _tensor_of(i[2], out.device)
            elif op == "MatMul":
                x, w = _operands(i[:2])
                out = x @ w
            elif op in ("Resize", "Upsample"):
                x = i[0]
                mode = a.get("mode", "nearest")
                if mode != "nearest":
                    raise NotImplementedError(f"Resize mode {mode}")
                sizes = i[3] if len(i) > 3 else None
                scales = i[2] if len(i) > 2 else (i[1] if op == "Upsample" else None)
                if sizes is not None and np.size(sizes):
                    hw = _ints(sizes)[-2:]
                else:
                    sc = np.asarray(scales).reshape(-1)
                    hw = [int(round(x.shape[2] * sc[-2])),
                          int(round(x.shape[3] * sc[-1]))]
                out = _resize_nearest(x, hw)
            elif op == "Shape":
                out = np.asarray(tuple(i[0].shape), np.int64)
            elif op == "Gather":
                idx = np.asarray(i[1])
                ax = a.get("axis", 0)
                if _is_static(i[0]):
                    out = np.take(np.asarray(i[0]), idx, axis=ax)
                else:
                    ax %= i[0].ndim
                    flat = np.where(idx < 0, idx + i[0].shape[ax], idx).reshape(-1)
                    out = i[0].index_select(ax, torch.as_tensor(flat, device=i[0].device))
                    out = out.reshape(i[0].shape[:ax] + idx.shape + i[0].shape[ax + 1:])
            elif op == "Unsqueeze":
                axes = a.get("axes") or _ints(i[1])
                out = i[0]
                for ax in sorted(axes):
                    out = np.expand_dims(out, ax) if _is_static(out) else out.unsqueeze(ax)
            elif op == "Squeeze":
                axes = a.get("axes") or (
                    _ints(i[1]) if len(i) > 1 and i[1] is not None else None
                )
                if _is_static(i[0]):
                    out = np.squeeze(i[0], axis=tuple(axes) if axes else None)
                else:
                    out = i[0].squeeze(tuple(axes)) if axes else i[0].squeeze()
            elif op == "Cast":
                to = _DTYPES[a["to"] if not isinstance(a["to"], list) else a["to"][0]]
                out = np.asarray(i[0], to) if _is_static(i[0]) else i[0].to(_torch_dtype(to))
            elif op == "Constant":
                out = a.get("value")
            elif op in ("Identity", "Dropout"):
                out = i[0]
            elif op == "Slice":
                starts, ends = _ints(i[1]), _ints(i[2])
                axes = (
                    _ints(i[3]) if len(i) > 3 and i[3] is not None
                    else list(range(len(starts)))
                )
                steps = (
                    _ints(i[4]) if len(i) > 4 and i[4] is not None
                    else [1] * len(starts)
                )
                out = i[0]
                for s, e, ax, st in zip(starts, ends, axes, steps):
                    out = _slice_axis(out, ax, s, None if e >= 2**31 - 1 else e, st)
            elif op == "ConstantOfShape":
                shape = _ints(i[0])
                fill = a.get("value")
                fill = (
                    np.zeros((), np.float32) if fill is None
                    else np.asarray(fill).reshape(())
                )
                out = np.full(shape, fill, dtype=fill.dtype)
            elif op == "Expand":
                # onnx Expand is two-sided numpy broadcasting: an input
                # dim may exceed the target dim's 1
                shape = np.broadcast_shapes(tuple(i[0].shape), tuple(_ints(i[1])))
                out = np.broadcast_to(i[0], shape) if _is_static(i[0]) else i[0].expand(shape)
            elif op == "Tile":
                reps = _ints(i[1])
                out = np.tile(i[0], reps) if _is_static(i[0]) else i[0].repeat(reps)
            elif op == "Range":
                s0, lim, d0 = (int(np.asarray(v)) for v in i[:3])
                out = np.arange(s0, lim, d0, dtype=np.asarray(i[0]).dtype)
            elif op == "Where":
                if all(_is_static(v) for v in i[:3]):
                    out = np.where(i[0], i[1], i[2])
                else:
                    out = torch.where(*_operands(i[:3]))
            else:
                raise NotImplementedError(f"ONNX op {op} ({node.name})")
            outs = [out] if not isinstance(out, tuple) else list(out)
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val
        return {name: env[name] for name in graph.outputs}

    return fn, params

# --------------------------------------------------------------------------
# SCRFD adapter
# --------------------------------------------------------------------------


def scrfd_raw_heads(
    outputs: dict[str, np.ndarray],
    graph: OnnxGraph,
    input_hw: tuple[int, int],
    strides: tuple[int, ...] = (8, 16, 32),
    num_anchors: int = 2,
) -> dict[str, list]:
    """Map the SCRFD graph's 9 outputs (per-stride score/bbox/kps, each
    [N, h*w*A, C] in insightface's output order) onto the NHWC per-level
    dict `fairdiff.models.face_detector.decode_detections` consumes.

    Output-to-stride assignment follows insightface's convention: outputs
    appear grouped as [scores x3, bboxes x3, kps x3] in stride order
    (insightface scrfd.py `forward`), identified here by channel count
    (1 / 4 / 10) and anchor count from the spatial size.
    """
    vals = [outputs[name] for name in graph.outputs]  # may be traced
    by_kind: dict[int, list] = {1: [], 4: [], 10: []}
    for v in vals:
        by_kind[v.shape[-1]].append(v)
    heads: dict[str, list] = {"score": [], "bbox": [], "kps": []}
    H, W = input_hw
    for level, stride in enumerate(strides):
        h, w = H // stride, W // stride
        for kind, key in ((1, "score"), (4, "bbox"), (10, "kps")):
            v = by_kind[kind][level]  # [N, h*w*A, C]
            n = v.shape[0]
            v = v.reshape(n, h, w, num_anchors * kind)
            heads[key].append(v)
    return heads



def load_scrfd(
    path: str,
    *,
    input_size: tuple[int, int] = (640, 640),
    strides: tuple[int, ...] = (8, 16, 32),
    num_anchors: int = 2,
    score_threshold: float = 0.5,
    device: torch.device | str = "cpu",
):
    """-> (detect(params, images), params), the weights on `device` in the
    graph's stored dtype (fp32 for det_10g: the reference runs it in fp32).

    images: [N, H, W, 3] RGB in [-1, 1]. SCRFD's preprocessing is
    (pixel - 127.5) / 128 on BGR (insightface `detect`): the same as
    flipping the channels and scaling by 127.5 / 128.
    """
    graph = parse_onnx(str(path))
    fn, params = build_onnx_fn(graph)
    params = {k: v.to(device) for k, v in params.items()}
    cfg = DetectorConfig(
        strides=strides, num_anchors=num_anchors,
        score_threshold=score_threshold,
        # det_10g-style graphs end score heads with a Sigmoid node:
        # outputs are probabilities already (insightface thresholds them
        # directly), so the decode must not sigmoid a second time
        scores_are_logits=False,
    )
    in_name = graph.inputs[0]
    H, W = input_size

    def detect(p, images: torch.Tensor):
        x = resize(images, (images.shape[0], H, W, 3), "bilinear")
        x = x.flip(-1) * (127.5 / 128.0)  # RGB->BGR, insightface scaling
        x = x.permute(0, 3, 1, 2)  # NCHW (onnx native)
        # the feed follows the weights' float dtype (conv takes one dtype)
        float_leaf = next((v for v in p.values() if v.is_floating_point()), None)
        if float_leaf is not None:
            x = x.to(float_leaf.dtype)
        outs = fn(p, {in_name: x})
        raw = scrfd_raw_heads(outs, graph, (H, W), strides, num_anchors)
        scores, boxes, kps = decode_detections(raw, cfg)
        # rescale from the 640-sq working frame back to image coords
        sy = images.shape[1] / H
        sx = images.shape[2] / W
        boxes = boxes * torch.tensor([sx, sy, sx, sy], device=boxes.device)
        kps = kps * torch.tensor([sx, sy], device=kps.device)
        return select_largest_face(scores, boxes, kps, cfg.score_threshold)

    return detect, params
