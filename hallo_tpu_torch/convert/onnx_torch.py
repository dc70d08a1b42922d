"""Execute ONNX graphs with PyTorch (counterpart of
hallo_tpu/convert/onnx_jax.py; the reference runs these models through
onnxruntime, image_processor.py:100-138 and audio_processor.py:56-70).

- One callable from the graph: `run(params, inputs) -> outputs`, with the
  float weights (`params`) as tensors on the executor's device (the card
  unless the caller asks for another) and `__call__(inputs)` taking the
  executor's own.
- Exported graphs carry shape subgraphs (Shape -> Gather -> Unsqueeze ->
  Concat -> Reshape). Every value is either a host `np.ndarray` constant or
  a tensor on the device, and an op of `_FOLDABLE` whose inputs are all host
  constants runs on the host in numpy, as onnx_jax.py's do; the graph body
  runs on tensors. A host constant that meets a tensor joins it on the
  device (float64 as float32, as JAX's default precision has it).
- ONNX is NCHW, and so is torch: convolutions are `F.conv{1,2,3}d` and
  `F.conv_transpose{1,2,3}d` (cuDNN on the card), as the JAX package runs
  these graphs through XLA and not through a Pallas kernel
  (onnx_jax.py:17-20). The models run once per image or audio chunk.
- The graphs run in fp32: `run` turns TF32 off for cuDNN's convolutions
  and cuBLAS's products while it runs (`fp32_only`). PyTorch's default
  lets cuDNN use TF32, whose 10-bit mantissa moves a deep graph's outputs
  by orders of magnitude more than fp32 in another order of sums does.

The op set is onnx_jax.py's (`supported_ops`), and a graph with another op
raises `UnsupportedOnnxOps` at construction (`strict`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from hallo_tpu_torch.convert.onnx_io import OnnxModel, OnnxNode, load_onnx

Value = Union[np.ndarray, torch.Tensor]

# Ops that fold on the host when every input is a host constant.
_FOLDABLE = {
    "Shape", "Gather", "Slice", "Concat", "Unsqueeze", "Squeeze", "Cast",
    "Add", "Sub", "Mul", "Div", "Reshape", "Transpose", "Constant",
    "ConstantOfShape", "Range", "Identity", "Expand", "Where", "Equal",
    "ReduceProd", "Floor", "Ceil",
}

# TensorProto.DataType -> (numpy, torch)
_CAST = {
    1: (np.float32, torch.float32), 6: (np.int32, torch.int32), 7: (np.int64, torch.int64),
    9: (np.bool_, torch.bool), 10: (np.float16, torch.float16),
    11: (np.float64, torch.float64), 2: (np.uint8, torch.uint8), 3: (np.int8, torch.int8),
}


def _is_host(*vals: Value) -> bool:
    return all(isinstance(v, np.ndarray) or np.isscalar(v) for v in vals)


def _ints(v) -> List[int]:
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return [int(x) for x in np.asarray(v).reshape(-1)]


def _pair(v: Optional[Sequence[int]], default: int, n: int = 2) -> Tuple[int, ...]:
    if v is None:
        return (default,) * n
    return tuple(int(x) for x in v)


def _conv_padding(pads: Optional[Sequence[int]], spatial: int) -> List[Tuple[int, int]]:
    if pads is None:
        return [(0, 0)] * spatial
    pads = [int(p) for p in pads]
    return [(pads[i], pads[i + spatial]) for i in range(spatial)]


def _torch_pad(pads: Sequence[Tuple[int, int]]) -> List[int]:
    """Per-axis (begin, end) pairs, first axis first -> F.pad's list, last
    axis first."""
    out: List[int] = []
    for lo, hi in reversed(list(pads)):
        out += [lo, hi]
    return out


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@contextlib.contextmanager
def fp32_only():
    """cuDNN's and cuBLAS's TF32 switches off, and restored afterwards."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class UnsupportedOnnxOps(NotImplementedError):
    """Raised at executor construction when the graph uses ops the executor
    has no implementation for. Carries the sorted unique op list."""

    def __init__(self, ops: Sequence[str]):
        self.ops = sorted(set(ops))
        super().__init__(
            "ONNX graph uses unsupported op(s): " + ", ".join(self.ops)
            + " — extend OnnxExecutor (_op_<name>) or export the model "
            "without them"
        )


class OnnxExecutor:
    """An OnnxModel as one callable on tensors.

    `params`: the float initializers of at least PARAM_MIN_SIZE elements, as
    fp32 tensors on `device`. Smaller or integer initializers (shape
    vectors, axes) stay host constants, so that the shape subgraphs fold."""

    PARAM_MIN_SIZE = 65

    def __init__(
        self,
        model: Union[OnnxModel, str, bytes],
        strict: bool = True,
        device: torch.device = torch.device("cuda"),
    ):
        if not isinstance(model, OnnxModel):
            model = load_onnx(model)
        self.graph = model.graph
        self.opset = model.opset
        if strict:
            missing = self.check_support(self.graph)
            if missing:
                raise UnsupportedOnnxOps(missing)
        self.device = torch.device(device)
        self.params: Dict[str, torch.Tensor] = {}
        self._consts: Dict[str, np.ndarray] = {}
        for k, arr in self.graph.initializers.items():
            if arr.dtype.kind == "f" and arr.size >= self.PARAM_MIN_SIZE:
                self.params[k] = torch.as_tensor(arr).to(self.device, torch.float32)
            else:
                self._consts[k] = arr
        self.input_names = [n for n, _ in self.graph.inputs]
        self.output_names = list(self.graph.outputs)

    # -- public ------------------------------------------------------------
    @torch.inference_mode()
    def run(self, params: Dict[str, torch.Tensor],
            inputs: Dict[str, Value]) -> Dict[str, torch.Tensor]:
        """The graph's outputs, as tensors on the device, from `inputs`
        (numpy arrays or tensors, which go to the device) and `params`."""
        vals: Dict[str, Value] = dict(self._consts)
        vals.update(params)
        for k, v in inputs.items():
            vals[k] = self._tensor(v)
        with fp32_only():
            for node in self.graph.nodes:
                args = [vals[i] if i else None for i in node.inputs]
                outs = self._run_node(node, args)
                if not isinstance(outs, tuple):
                    outs = (outs,)
                for name, o in zip(node.outputs, outs):
                    if name:
                        vals[name] = o
        return {k: self._tensor(vals[k]) for k in self.output_names}

    def __call__(self, inputs: Dict[str, Value]) -> Dict[str, torch.Tensor]:
        return self.run(self.params, inputs)

    @classmethod
    def supported_ops(cls) -> frozenset:
        """ONNX op types this executor can dispatch (from its _op_<name>
        methods), lowercase."""
        return frozenset(name[len("_op_"):] for name in dir(cls) if name.startswith("_op_"))

    @classmethod
    def check_support(cls, graph) -> List[str]:
        """Sorted unique op types of `graph` the executor cannot run."""
        ok = cls.supported_ops()
        return sorted({n.op_type for n in graph.nodes if n.op_type.lower() not in ok})

    # -- dispatch ----------------------------------------------------------
    def _tensor(self, v: Value) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v
        arr = np.asarray(v)
        t = torch.as_tensor(arr)
        if t.dtype == torch.float64:
            t = t.float()
        return t.to(self.device)

    def _run_node(self, node: OnnxNode, args: List[Optional[Value]]):
        fn = getattr(self, f"_op_{node.op_type.lower()}", None)
        if fn is None:
            raise NotImplementedError(
                f"ONNX op {node.op_type!r} (node {node.name!r}) is not "
                "supported by OnnxExecutor")
        host = node.op_type in _FOLDABLE and _is_host(*[a for a in args if a is not None])
        if host:
            out = fn(True, node.attrs, *args)
            if not isinstance(out, (np.ndarray, tuple)):
                out = np.asarray(out)
            return out
        return fn(False, node.attrs, *[None if a is None else self._tensor(a) for a in args])

    # -- elementwise / math --------------------------------------------------
    def _op_add(self, host, a, x, y):
        return x + y

    def _op_sub(self, host, a, x, y):
        return x - y

    def _op_mul(self, host, a, x, y):
        return x * y

    def _op_div(self, host, a, x, y):
        return x / y

    def _op_pow(self, host, a, x, y):
        return x ** y

    def _op_neg(self, host, a, x):
        return -x

    def _op_sqrt(self, host, a, x):
        return torch.sqrt(x)

    def _op_exp(self, host, a, x):
        return torch.exp(x)

    def _op_log(self, host, a, x):
        return torch.log(x)

    def _op_floor(self, host, a, x):
        return np.floor(x) if host else torch.floor(x)

    def _op_ceil(self, host, a, x):
        return np.ceil(x) if host else torch.ceil(x)

    def _op_min(self, host, a, *xs):
        out = xs[0]
        for x in xs[1:]:
            out = torch.minimum(out, x)
        return out

    def _op_max(self, host, a, *xs):
        out = xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x)
        return out

    def _op_relu(self, host, a, x):
        return torch.clamp_min(x, 0)

    def _op_leakyrelu(self, host, a, x):
        alpha = a.get("alpha", 0.01)
        return torch.where(x >= 0, x, alpha * x)

    def _op_prelu(self, host, a, x, slope):
        while slope.ndim < x.ndim:  # unidirectional broadcast
            slope = slope[None]
        return torch.where(x >= 0, x, slope * x)

    def _op_sigmoid(self, host, a, x):
        return torch.sigmoid(x)

    def _op_tanh(self, host, a, x):
        return torch.tanh(x)

    def _op_erf(self, host, a, x):
        return torch.erf(x)

    def _op_softmax(self, host, a, x):
        axis = a.get("axis", -1 if self.opset >= 13 else 1)
        return torch.softmax(x, dim=int(axis))

    def _op_clip(self, host, a, x, lo=None, hi=None):
        lo = a.get("min", lo)
        hi = a.get("max", hi)
        if lo is not None:
            x = torch.maximum(x, self._tensor(lo).to(x.dtype))
        if hi is not None:
            x = torch.minimum(x, self._tensor(hi).to(x.dtype))
        return x

    def _op_where(self, host, a, c, x, y):
        return np.where(c, x, y) if host else torch.where(c.bool(), x, y)

    def _op_equal(self, host, a, x, y):
        return x == y

    def _op_identity(self, host, a, x):
        return x

    def _op_dropout(self, host, a, x, *rest):
        return x  # eval mode; the optional mask output is unused

    def _op_cast(self, host, a, x):
        np_dtype, torch_dtype = _CAST[int(a["to"])]
        return np.asarray(x).astype(np_dtype) if host else x.to(torch_dtype)

    # -- reductions ----------------------------------------------------------
    @staticmethod
    def _axes(a, axes_in):
        axes = a.get("axes", axes_in)
        return None if axes is None else tuple(_ints(axes))

    def _op_reducemean(self, host, a, x, axes=None):
        axes, keep = self._axes(a, axes), bool(a.get("keepdims", 1))
        return torch.mean(x, dim=axes, keepdim=keep)

    def _op_reducesum(self, host, a, x, axes=None):
        axes, keep = self._axes(a, axes), bool(a.get("keepdims", 1))
        return torch.sum(x, dim=axes, keepdim=keep)

    def _op_reducemax(self, host, a, x, axes=None):
        axes, keep = self._axes(a, axes), bool(a.get("keepdims", 1))
        return torch.amax(x, dim=() if axes is None else axes, keepdim=keep)

    def _op_reduceprod(self, host, a, x, axes=None):
        axes, keep = self._axes(a, axes), bool(a.get("keepdims", 1))
        if host:
            return np.prod(x, axis=axes, keepdims=keep)
        for ax in sorted((d % x.ndim for d in (axes or range(x.ndim))), reverse=True):
            x = torch.prod(x, dim=ax, keepdim=keep)
        return x

    # -- shape plumbing --------------------------------------------------------
    def _op_shape(self, host, a, x):
        return np.asarray(x.shape, np.int64)  # always a host constant

    def _op_constant(self, host, a):
        if "value" in a:
            return np.asarray(a["value"])
        for k in ("value_float", "value_int"):
            if k in a:
                return np.asarray(a[k])
        raise NotImplementedError("Constant without tensor value")

    def _op_constantofshape(self, host, a, shape):
        val = a.get("value")
        fill = np.asarray(val).reshape(-1)[0] if val is not None else np.float32(0)
        return np.full(tuple(_ints(shape)), fill)

    def _op_range(self, host, a, start, limit, delta):
        return np.arange(_ints(start)[0], _ints(limit)[0], _ints(delta)[0], np.int64)

    def _op_reshape(self, host, a, x, shape):
        target = [int(x.shape[i]) if s == 0 else s for i, s in enumerate(_ints(shape))]
        return np.reshape(x, target) if host else torch.reshape(x, target)

    def _op_flatten(self, host, a, x):
        axis = int(a.get("axis", 1))
        lead = int(np.prod(x.shape[:axis])) if axis else 1
        return torch.reshape(x, (lead, -1))

    def _op_transpose(self, host, a, x):
        perm = a.get("perm")
        perm = list(range(x.ndim))[::-1] if perm is None else [int(p) for p in perm]
        return np.transpose(x, perm) if host else x.permute(perm)

    def _op_concat(self, host, a, *xs):
        axis = int(a["axis"])
        return np.concatenate(xs, axis=axis) if host else torch.cat(xs, dim=axis)

    def _op_gather(self, host, a, x, idx):
        axis = int(a.get("axis", 0))
        if host:
            return np.take(x, idx, axis=axis)
        axis %= x.ndim
        idx = idx.long()
        idx = torch.where(idx < 0, idx + x.shape[axis], idx)
        out = torch.index_select(x, axis, idx.reshape(-1))
        return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape) + tuple(x.shape[axis + 1:]))

    def _op_unsqueeze(self, host, a, x, axes=None):
        for ax in sorted(_ints(a.get("axes", axes))):
            ax = ax if ax >= 0 else ax + x.ndim + 1
            x = np.expand_dims(x, ax) if host else x.unsqueeze(ax)
        return x

    def _op_squeeze(self, host, a, x, axes=None):
        axes = a.get("axes", axes)
        if axes is None:
            return np.squeeze(x) if host else x.squeeze()
        axes = tuple(v % x.ndim for v in _ints(axes))
        return np.squeeze(x, axis=axes) if host else x.squeeze(axes)

    def _op_slice(self, host, a, x, starts=None, ends=None, axes=None, steps=None):
        starts = _ints(a.get("starts", starts))
        ends = _ints(a.get("ends", ends))
        axes = a.get("axes", axes)
        steps = a.get("steps", steps)
        axes = list(range(len(starts))) if axes is None else [v % x.ndim for v in _ints(axes)]
        steps = [1] * len(starts) if steps is None else _ints(steps)
        if host:
            sl = [slice(None)] * x.ndim
            for st, en, ax, sp in zip(starts, ends, axes, steps):
                lim = int(x.shape[ax])
                sl[ax] = slice(st, max(min(en, lim), -lim - 1), sp)
            return x[tuple(sl)]
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            lim = int(x.shape[ax])
            rng = range(*slice(st, max(min(en, lim), -lim - 1), sp).indices(lim))
            if sp == 1:
                x = x.narrow(ax, rng.start, len(rng))
            else:  # torch slices take no negative step: index the kept rows
                x = torch.index_select(x, ax, torch.tensor(list(rng), dtype=torch.long,
                                                           device=x.device))
        return x

    def _op_pad(self, host, a, x, pads=None, value=None, axes=None):
        """Pad: the opset<11 attribute form and the opset>=11 input form.
        ONNX pads are [begin_0..begin_{r-1}, end_0..end_{r-1}] over the
        padded axes (all axes when `axes` is absent)."""
        mode = a.get("mode", "constant")
        mode = mode.decode() if isinstance(mode, bytes) else str(mode)
        pads = _ints(a.get("pads", pads))
        value = float(a.get("value", 0.0)) if value is None else float(_tensor_item(value))
        idx = list(range(x.ndim)) if axes is None else [v % x.ndim for v in _ints(axes)]
        n = len(idx)
        width = [(0, 0)] * x.ndim
        for k, ax in enumerate(idx):
            width[ax] = (pads[k], pads[n + k])
        if mode == "constant":
            return F.pad(x, _torch_pad(width), value=value)
        tmode = {"reflect": "reflect", "edge": "replicate", "wrap": "circular"}.get(mode)
        if tmode is None:
            raise NotImplementedError(f"Pad mode {mode!r}")
        if any(lo or hi for lo, hi in width[:2]) or x.ndim < 3:  # torch pads only the trailing axes here
            raise NotImplementedError(f"Pad mode {mode!r} on batch or channel axes")
        return F.pad(x, _torch_pad(width[2:]), mode=tmode)

    def _op_split(self, host, a, x, split=None):
        axis = int(a.get("axis", 0))
        split = a.get("split", split)
        if split is None:
            raise NotImplementedError("Split without explicit sizes")
        return tuple(torch.split(x, _ints(split), dim=axis))

    def _op_expand(self, host, a, x, shape):
        out_shape = tuple(np.broadcast_shapes(tuple(x.shape), tuple(_ints(shape))))
        return np.broadcast_to(x, out_shape) if host else x.broadcast_to(out_shape)

    def _op_tile(self, host, a, x, reps):
        return torch.tile(x, tuple(_ints(reps)))

    # -- linear algebra --------------------------------------------------------
    def _op_matmul(self, host, a, x, y):
        return torch.matmul(x, y)

    def _op_gemm(self, host, a, x, w, b=None):
        alpha = a.get("alpha", 1.0)
        beta = a.get("beta", 1.0)
        if a.get("transA", 0):
            x = x.T
        if a.get("transB", 0):
            w = w.T
        out = alpha * torch.matmul(x, w)
        if b is not None:
            out = out + beta * b
        return out

    # -- NN ops ------------------------------------------------------------
    def _op_conv(self, host, a, x, w, b=None):
        spatial = x.ndim - 2
        strides = _pair(a.get("strides"), 1, spatial)
        dilations = _pair(a.get("dilations"), 1, spatial)
        groups = int(a.get("group", 1))
        if a.get("auto_pad", "NOTSET") not in ("NOTSET", ""):
            k = w.shape[2:]
            pads = []
            for i in range(spatial):
                eff = (k[i] - 1) * dilations[i] + 1
                out = math.ceil(x.shape[2 + i] / strides[i])
                total = max(0, (out - 1) * strides[i] + eff - x.shape[2 + i])
                if a["auto_pad"] == "SAME_UPPER":
                    pads.append((total // 2, total - total // 2))
                else:
                    pads.append((total - total // 2, total // 2))
        else:
            pads = _conv_padding(a.get("pads"), spatial)
        if any(lo != hi for lo, hi in pads):
            x, padding = F.pad(x, _torch_pad(pads)), 0
        else:
            padding = tuple(lo for lo, _ in pads)
        return _CONV[spatial](x, w, b, strides, padding, dilations, groups)

    def _op_convtranspose(self, host, a, x, w, b=None):
        spatial = x.ndim - 2
        strides = _pair(a.get("strides"), 1, spatial)
        dilations = _pair(a.get("dilations"), 1, spatial)
        if int(a.get("group", 1)) != 1:
            raise NotImplementedError("grouped ConvTranspose")
        pads = _conv_padding(a.get("pads"), spatial)
        out_pad = _pair(a.get("output_padding"), 0, spatial)
        # The full transposed conv (no padding), then the ONNX window:
        # `output_padding` rows past its end (no input reaches them) and the
        # pads cropped from each side.
        full = _CONV_T[spatial](x, w, None, strides, 0, 0, 1, dilations)
        full = F.pad(full, _torch_pad([(0, p) for p in out_pad]))
        for i, (lo, hi) in enumerate(pads):
            full = full.narrow(2 + i, lo, full.shape[2 + i] - lo - hi)
        if b is not None:
            full = full + b.reshape((1, -1) + (1,) * spatial)
        return full

    def _op_instancenormalization(self, host, a, x, scale, bias):
        eps = a.get("epsilon", 1e-5)
        axes = tuple(range(2, x.ndim))
        mu = torch.mean(x, dim=axes, keepdim=True)
        var = torch.mean((x - mu) ** 2, dim=axes, keepdim=True)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return (x - mu) * torch.rsqrt(var + eps) * scale.reshape(shape) + bias.reshape(shape)

    def _op_batchnormalization(self, host, a, x, scale, bias, mean, var):
        eps = a.get("epsilon", 1e-5)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        inv = torch.rsqrt(var.float() + eps).to(x.dtype)
        return (x - mean.reshape(shape)) * (inv * scale).reshape(shape) + bias.reshape(shape)

    def _pool_pads(self, a, x):
        spatial = x.ndim - 2
        k = tuple(int(v) for v in a["kernel_shape"])
        strides = _pair(a.get("strides"), 1, spatial)
        pads = _conv_padding(a.get("pads"), spatial)
        if a.get("ceil_mode", 0):
            new_pads = []
            for i in range(spatial):
                size = x.shape[2 + i] + pads[i][0] + pads[i][1]
                out = math.ceil((size - k[i]) / strides[i]) + 1
                need = (out - 1) * strides[i] + k[i] - size
                new_pads.append((pads[i][0], pads[i][1] + max(0, need)))
            pads = new_pads
        return spatial, k, strides, _torch_pad(pads)

    def _op_maxpool(self, host, a, x):
        spatial, k, strides, pads = self._pool_pads(a, x)
        return _MAX_POOL[spatial](F.pad(x, pads, value=-math.inf), k, strides)

    def _op_averagepool(self, host, a, x):
        spatial, k, strides, pads = self._pool_pads(a, x)
        out = _AVG_POOL[spatial](F.pad(x, pads), k, strides)
        if a.get("count_include_pad", 0):
            return out
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
        return out / _AVG_POOL[spatial](F.pad(ones, pads), k, strides)

    def _op_globalaveragepool(self, host, a, x):
        return torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)

    def _op_upsample(self, host, a, x, scales=None):
        scales = a.get("scales", scales)
        return self._resize_common(x, np.asarray(_host(scales), np.float64).reshape(-1), None,
                                   a.get("mode", "nearest"), "asymmetric")

    def _op_resize(self, host, a, x, roi=None, scales=None, sizes=None):
        sc = None
        if scales is not None and scales.numel():
            sc = np.asarray(_host(scales), np.float64).reshape(-1)
        sz = None
        if sizes is not None and sizes.numel():
            sz = _ints(sizes)
        mode = a.get("mode", "nearest")
        coord = a.get("coordinate_transformation_mode", "half_pixel")
        return self._resize_common(x, sc, sz, mode, coord)

    def _resize_common(self, x, scales, sizes, mode, coord):
        if sizes is None:
            sizes = [int(math.floor(s * d)) for s, d in zip(scales, x.shape)]
        if list(sizes[:2]) != list(x.shape[:2]):
            raise NotImplementedError("Resize on batch/channel dims")
        in_sp = x.shape[2:]
        out_sp = sizes[2:]
        if "nearest" in mode:
            out = x
            for d, (oi, ii) in enumerate(zip(out_sp, in_sp)):
                ratio = ii / oi
                if coord == "asymmetric":
                    src = np.floor(np.arange(oi) * ratio)
                else:  # half_pixel, round_prefer_floor ~ floor(+0.5 shift)
                    src = np.floor((np.arange(oi) + 0.5) * ratio)
                idx = torch.as_tensor(np.clip(src, 0, ii - 1).astype(np.int64), device=x.device)
                out = torch.index_select(out, 2 + d, idx)
            return out
        # linear: half-pixel bilinear, antialiased when it shrinks (as
        # jax.image.resize, which onnx_jax.py uses)
        shrink = any(o < i for o, i in zip(out_sp, in_sp))
        return F.interpolate(x, size=tuple(out_sp), mode="bilinear", align_corners=False,
                             antialias=shrink)


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _tensor_item(v) -> float:
    return float(_host(v).reshape(()))
