"""Synthetic stand-ins for the reference's model files, for runs on a host
that holds none of them (chip_smoke.py's "onnx" and "cli" phases, the
tests). Nothing here is a trained weight: every value comes from a seed.

- `write_pretrained_layout`: the reference's `pretrained_models/` checkpoint
  files (configs/inference/default.yaml:24-41) with every key and shape of
  the inventories (`convert/weight_inventory.py`), values from a seed per
  file, in fp16 as the published files are;
- ONNX graphs of the four models' published architectures at their
  published depths and widths, written with `onnx_io.save_onnx`: SCRFD-10G
  with keypoints (scrfd_10g_bnkps), IResNet-100 (glintr100), the MediaPipe
  face mesh and MDX-Net's TFC-TDF U-Net at Kim_Vocal_2's dims; and an
  identity MDX graph, whose separator gives its input back.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from safetensors.torch import save_file

from hallo_tpu_torch.convert import weight_inventory as wi
from hallo_tpu_torch.convert.onnx_io import OnnxNode, save_onnx
from hallo_tpu_torch.data.mdx_separator import KIM_VOCAL_2_DIMS

Inventory = Mapping[str, Tuple[int, ...]]

# file -> (path under the root, inventory, seed); the seeds differ, so that
# the merge order of the loader shows
PRETRAINED_FILES = {
    "sd15_unet": ("stable-diffusion-v1-5/unet/diffusion_pytorch_model.safetensors",
                  wi.sd15_unet_inventory, 11),
    "sd_vae_ft_mse": ("sd-vae-ft-mse/diffusion_pytorch_model.safetensors",
                      wi.sd_vae_inventory, 12),
    "animatediff_mm": ("motion_module/mm_sd_v15_v2.ckpt", wi.animatediff_mm_inventory, 13),
    "net_pth": ("hallo/net.pth", wi.net_pth_inventory, 14),
    "wav2vec2": ("wav2vec/wav2vec2-base-960h/model.safetensors", wi.wav2vec2_inventory, 15),
}


def synthetic_tensor(key: str, shape, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """A value of an initialiser's scale: a weight of two or more axes
    N(0, 1/fan_in); a norm's scale 1 + N(0, 0.02^2); any other vector (a
    bias) N(0, 0.02^2)."""
    t = torch.randn(tuple(shape), generator=gen, device=device)
    if len(shape) >= 2:
        return t * float(np.prod(shape[1:])) ** -0.5
    if "norm" in key and key.endswith("weight"):
        return 1.0 + 0.02 * t
    return 0.02 * t


def synthetic_state_dict(inventory: Inventory, seed: int,
                         device: torch.device = torch.device("cpu")) -> Dict[str, torch.Tensor]:
    """`inventory`'s keys and shapes with values from `seed` (made on
    `device`, returned on the host in fp16)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return {k: synthetic_tensor(k, shape, gen, device).half().cpu()
            for k, shape in inventory.items()}


def write_pretrained_layout(
    root: str,
    inventories: Optional[Mapping[str, Callable[[], Inventory]]] = None,
    device: torch.device = torch.device("cpu"),
    keep: Optional[Mapping[str, Sequence[str]]] = None,
) -> Tuple[Dict[str, str], Dict[str, Dict[str, torch.Tensor]]]:
    """Write the five checkpoint files under `root` in the reference's
    layout (`PRETRAINED_FILES`), each from its inventory (or the stand-in in
    `inventories`) and seed. Returns ({name: path}, {name: {key: value}})
    with the values written for the keys of `keep`."""
    paths, kept = {}, {}
    for name, (rel, inventory, seed) in PRETRAINED_FILES.items():
        inventory = (inventories or {}).get(name, inventory)
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        sd = synthetic_state_dict(inventory(), seed, device)
        if path.endswith(".safetensors"):
            save_file(sd, path)
        else:
            torch.save(sd, path)
        kept[name] = {k: sd[k].clone() for k in (keep or {}).get(name, ())}
        del sd
        paths[name] = path
    return paths, kept


# -- ONNX graphs ---------------------------------------------------------------
# The four models' published architectures at their published depths and
# widths, with seeded weights, as torch.onnx.export writes them in eval
# mode: a BatchNorm that follows a Conv is folded into it, any other stays a
# BatchNormalization node. Each function can fill `stats` with the graph's
# parameter count and the multiply-adds of its convolutions and products
# (batch 1), and writes nothing when `path` is None.
def _node(op, inputs, outputs, **attrs) -> OnnxNode:
    return OnnxNode(op, list(inputs), list(outputs), attrs)


class _Graph:
    """Builds a graph node by node: seeded float32 initialisers, each
    value's shape and the multiply-adds so far. Weights are drawn at the
    scale that keeps activations of order one (`gain` / sqrt(fan_in))."""

    def __init__(self, seed: int, inputs: Dict[str, Sequence[int]]):
        self.rng = np.random.default_rng(seed)
        self.nodes: List[OnnxNode] = []
        self.inits: Dict[str, np.ndarray] = {}
        self.n, self.macs = 0, 0
        self.inputs = {k: list(v) for k, v in inputs.items()}
        self.shape: Dict[str, Tuple[int, ...]] = {k: tuple(v) for k, v in inputs.items()}

    def name(self, prefix: str) -> str:
        self.n += 1
        return f"{prefix}{self.n}"

    def const(self, arr) -> str:
        key = self.name("c")
        self.inits[key] = np.asarray(arr)
        return key

    def normal(self, shape, scale: float) -> str:
        return self.const((self.rng.standard_normal(shape) * scale).astype(np.float32))

    def op(self, op: str, inputs, shape, **attrs) -> str:
        y = self.name(op.lower())
        self.nodes.append(_node(op, inputs, [y], **attrs))
        self.shape[y] = tuple(shape)
        return y

    def act(self, x: str, kind: Optional[str]) -> str:
        if kind == "PRelu":
            slope = self.const(self.rng.uniform(0.2, 0.3, (self.shape[x][1], 1, 1))
                               .astype(np.float32))
            return self.op("PRelu", [x, slope], self.shape[x])
        return x if kind is None else self.op(kind, [x], self.shape[x])

    def conv(self, x: str, cout: int, k=3, stride=1, pad: Optional[int] = None,
             group: int = 1, act: Optional[str] = "Relu", gain: float = 2 ** 0.5) -> str:
        """Conv (+ its folded BatchNorm) + `act`; `k` and `stride` an int or
        an (h, w) pair."""
        n, cin, h, w = self.shape[x]
        kh, kw = (k, k) if isinstance(k, int) else k
        sh, sw = (stride, stride) if isinstance(stride, int) else stride
        ph, pw = (kh // 2, kw // 2) if pad is None else (pad, pad)
        oh, ow = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
        fan_in = cin // group * kh * kw
        wgt = self.normal((cout, cin // group, kh, kw), gain * fan_in ** -0.5)
        b = self.normal((cout,), 0.02)
        y = self.op("Conv", [x, wgt, b], (n, cout, oh, ow), kernel_shape=[kh, kw],
                    strides=[sh, sw], pads=[ph, pw, ph, pw], group=group)
        self.macs += cout * fan_in * oh * ow
        return self.act(y, act)

    def conv_transpose(self, x: str, cout: int, k: int, act: Optional[str] = "Relu") -> str:
        """ConvTranspose of kernel = stride `k` + BatchNormalization + `act`."""
        n, cin, h, w = self.shape[x]
        wgt = self.normal((cin, cout, k, k), 2 ** 0.5 * cin ** -0.5)
        y = self.op("ConvTranspose", [x, wgt, self.normal((cout,), 0.02)],
                    (n, cout, h * k, w * k), kernel_shape=[k, k], strides=[k, k])
        self.macs += cin * cout * k * k * h * w
        return self.act(self.bn(y), act)

    def bn(self, x: str) -> str:
        """A BatchNormalization on axis 1 near the identity."""
        c = self.shape[x][1]
        stats = [self.const(v.astype(np.float32)) for v in (
            self.rng.uniform(0.8, 1.2, c), 0.05 * self.rng.standard_normal(c),
            0.05 * self.rng.standard_normal(c), self.rng.uniform(0.8, 1.2, c))]
        return self.op("BatchNormalization", [x] + stats, self.shape[x], epsilon=1e-5)

    def matmul(self, x: str, n_out: int, gain: float = 2 ** 0.5) -> str:
        """x @ W over the last axis (an exported nn.Linear without bias)."""
        *lead, n_in = self.shape[x]
        self.macs += int(np.prod(lead)) * n_in * n_out
        return self.op("MatMul", [x, self.normal((n_in, n_out), gain * n_in ** -0.5)],
                       (*lead, n_out))

    def binary(self, op: str, a: str, b: str) -> str:
        return self.op(op, [a, b], self.shape[a])

    def flat_head(self, x: str, rows_of: int) -> str:
        """(1, c, h, w) -> (h * w * c / rows_of, rows_of) by Transpose and a
        Reshape whose target folds from Shape on the host (the exporters'
        pattern)."""
        n, c, h, w = self.shape[x]
        t = self.op("Transpose", [x], (n, h, w, c), perm=[0, 2, 3, 1])
        shape = self.op("Shape", [t], (4,))
        hh, ww = (self.op("Gather", [shape, self.const(np.array([i], np.int64))], (1,), axis=0)
                  for i in (1, 2))
        rows = self.binary("Mul", self.binary("Mul", hh, ww),
                           self.const(np.array([c // rows_of], np.int64)))
        target = self.op("Concat", [rows, self.const(np.array([rows_of], np.int64))], (2,),
                         axis=0)
        return self.op("Reshape", [t, target], (h * w * c // rows_of, rows_of))

    def finish(self, path: Optional[str], outputs: Sequence[str],
               stats: Optional[dict]) -> Optional[str]:
        if stats is not None:
            stats.update(params=int(sum(a.size for a in self.inits.values()
                                        if a.dtype.kind == "f")),
                         macs=int(self.macs), nodes=len(self.nodes))
        if path is None:
            return None
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        save_onnx(path, self.nodes, self.inits, self.inputs,
                  {y: list(self.shape[y]) for y in outputs})
        return path


SCRFD_SCORE_OFFSET = 2.3


def scrfd_graph(path: Optional[str], stats: Optional[dict] = None) -> Optional[str]:
    """SCRFD-10G with keypoints (insightface's scrfd_10g_bnkps config): a
    ResNetV1e backbone (a deep stem of three 3x3 convs and a max-pool;
    BasicBlocks of (3, 4, 2, 3) x (56, 88, 88, 224) channels, strides 1, 2,
    2, 2, average-pool shortcuts), a PAFPN of 56 channels on the stride-8,
    16 and 32 levels, and per stride 3 3x3 convs of 80 channels before the
    3x3 score, box and keypoint convs (2 anchors a cell). (1, 3, 640, 640)
    -> 9 outputs [score_8, score_16, score_32, bbox_*, kps_*], insightface's
    interface at its det size: scores sigmoid'd in the graph. 13.3 G
    multiply-adds, 10.0 G at 640x480 (the model's name). With random weights
    the score convs are biased low (`SCRFD_SCORE_OFFSET`), so that few
    anchors pass 0.5, and the boxes are 0-4 strides (a sigmoid), where the
    trained model emits them raw."""
    base, neck, head = 56, 56, 80
    g = _Graph(0, {"x": [1, 3, 640, 640]})
    x = g.conv("x", base // 2, stride=2)
    x = g.conv(x, base // 2)
    x = g.conv(x, base)
    n, c, h, w = g.shape[x]
    x = g.op("MaxPool", [x], (n, c, (h + 1) // 2, (w + 1) // 2), kernel_shape=[3, 3],
             strides=[2, 2], pads=[1, 1, 1, 1])
    levels = []
    for i, (blocks, planes) in enumerate(zip((3, 4, 2, 3), (56, 88, 88, 224))):
        for b in range(blocks):
            stride = 2 if i and not b else 1
            y = g.conv(g.conv(x, planes, stride=stride), planes, act=None, gain=0.5)
            short = x
            if stride != 1:
                n, c, h, w = g.shape[x]
                short = g.op("AveragePool", [x], (n, c, -(-h // 2), -(-w // 2)),
                             kernel_shape=[2, 2], strides=[2, 2], ceil_mode=1,
                             count_include_pad=0)
            if stride != 1 or g.shape[short][1] != planes:
                short = g.conv(short, planes, k=1, act=None, gain=1.0)
            x = g.act(g.binary("Add", y, short), "Relu")
        levels.append(x)
    # PAFPN from the stride-8 level: laterals, top-down sums, 3x3 convs,
    # then the bottom-up path (no norm, no activation, as mmdet's)
    lat = [g.conv(f, neck, k=1, act=None, gain=1.0) for f in levels[1:]]
    for i in (1, 0):
        n, c, h, w = g.shape[lat[i + 1]]
        up = g.op("Resize", [lat[i + 1], "", g.const(np.array([1, 1, 2, 2], np.float32))],
                  (n, c, 2 * h, 2 * w), mode="nearest")
        lat[i] = g.binary("Add", lat[i], up)
    inter = [g.conv(f, neck, act=None, gain=1.0) for f in lat]
    for i in (1, 2):
        inter[i] = g.binary("Add", inter[i], g.conv(inter[i - 1], neck, stride=2, act=None,
                                                    gain=0.5))
    feats = [inter[0]] + [g.conv(f, neck, act=None, gain=1.0) for f in inter[1:]]
    names = {"score": [], "bbox": [], "kps": []}
    for feat in feats:
        for _ in range(3):
            feat = g.conv(feat, head)
        for kind, ch in (("score", 2), ("bbox", 8), ("kps", 20)):
            raw = g.conv(feat, ch, act=None, gain=1.0)
            if kind == "score":  # wide logits, most of them below 0
                w_key, b_key = g.nodes[-1].inputs[1:]
                g.inits[w_key] *= 3.0
                g.inits[b_key] = g.inits[b_key] - SCRFD_SCORE_OFFSET
            out = g.flat_head(raw, ch // 2)
            if kind == "score":
                out = g.act(out, "Sigmoid")
            elif kind == "bbox":  # distances of 0-4 strides from the anchor
                out = g.binary("Mul", g.act(out, "Sigmoid"), g.const(np.float32([4.0])))
            names[kind].append(out)
    return g.finish(path, names["score"] + names["bbox"] + names["kps"], stats)


def arcface_graph(path: Optional[str], widths: Sequence[int] = (64, 128, 256, 512),
                  stats: Optional[dict] = None) -> Optional[str]:
    """IResNet-100, the ArcFace embedding of glintr100.onnx (insightface's
    arcface_torch `iresnet100`; `widths` as published by default): (1, 3,
    112, 112) -> (1, 512). A 3x3 conv + PReLU, then (3, 13, 30, 3)
    IBasicBlocks (BatchNorm, 3x3 conv, PReLU, 3x3 conv of stride 2 in a
    stage's first block, with a 1x1 shortcut there) of `widths` channels at
    56, 28, 14 and 7, then BatchNorm, Flatten, a Gemm of 7 x 7 x widths[-1]
    -> 512 and a BatchNorm. 12.1 G multiply-adds and 65.2 M parameters. The
    blocks' second conv is drawn small (gain 0.3), as the trained model's
    last BatchNorm scales are, so that 49 residual sums stay of order one."""
    dim = 512
    g = _Graph(1, {"x": [1, 3, 112, 112]})
    x = g.conv("x", widths[0], act="PRelu")
    for blocks, planes in zip((3, 13, 30, 3), widths):
        for b in range(blocks):
            stride = 2 if b == 0 else 1
            y = g.conv(g.conv(g.bn(x), planes, act="PRelu"), planes, stride=stride, act=None,
                       gain=0.3)
            short = x if b else g.conv(x, planes, k=1, stride=2, pad=0, act=None, gain=1.0)
            x = g.binary("Add", y, short)
    x = g.bn(x)
    n, c, h, w = g.shape[x]
    x = g.op("Flatten", [x], (1, c * h * w), axis=1)
    g.macs += c * h * w * dim
    y = g.op("Gemm", [x, g.normal((dim, c * h * w), (c * h * w) ** -0.5),
                      g.normal((dim,), 0.02)], (1, dim), transB=1)
    return g.finish(path, [g.bn(y)], stats)


def _mesh_block(g: _Graph, x: str, cout: int, stride: int = 1) -> str:
    """MediaPipe's face-mesh residual block: a 3x3 depthwise conv and a 1x1
    conv, the input (max-pooled at stride 2, zero channels appended) added,
    then PReLU."""
    n, cin, h, w = g.shape[x]
    if stride == 2:
        h_in = g.op("Pad", [x], (n, cin, h + 2, w + 2), mode="constant",
                    pads=[0, 0, 0, 0, 0, 0, 2, 2])
        x = g.op("MaxPool", [x], (n, cin, h // 2, w // 2), kernel_shape=[2, 2],
                 strides=[2, 2])
        y = g.conv(h_in, cin, stride=2, pad=0, group=cin, act=None, gain=1.0)
    else:
        y = g.conv(x, cin, group=cin, act=None, gain=1.0)
    y = g.conv(y, cout, k=1, act=None, gain=0.5)
    if cout > cin:
        n, _, h, w = g.shape[x]
        x = g.op("Pad", [x], (n, cout, h, w), mode="constant",
                 pads=[0, 0, 0, 0, 0, cout - cin, 0, 0])
    return g.act(g.binary("Add", y, x), "PRelu")


def face_mesh_graph(path: Optional[str], stats: Optional[dict] = None) -> Optional[str]:
    """The MediaPipe face mesh (face_landmark, 468 points; the layers of the
    published 192x192 model): (1, 3, 192, 192) in [0, 1] -> (1, 1404) in
    crop pixels and a (1, 1) face score. A 3x3 stride-2 conv + PReLU, 14
    residual blocks of 16-128 channels down to 6x6, then the landmark head
    (3 blocks, a 1x1 conv to 32, a block, a 3x3 conv to 1404) and the score
    head (a block, a 1x1 conv, a block, a 3x3 conv to 1). The landmark
    conv's bias is a ring of 468 points around the crop's centre, which its
    small weights move by a few pixels."""
    g = _Graph(2, {"x": [1, 3, 192, 192]})
    x = g.op("Pad", ["x"], (1, 3, 193, 193), mode="constant", pads=[0, 0, 0, 0, 0, 0, 1, 1])
    x = g.conv(x, 16, stride=2, pad=0, act="PRelu")
    for cout, stride in ((16, 1), (16, 1), (32, 2), (32, 1), (32, 1), (64, 2), (64, 1),
                         (64, 1), (128, 2), (128, 1), (128, 1), (128, 2), (128, 1), (128, 1)):
        x = _mesh_block(g, x, cout, stride)
    theta = np.linspace(0, 2 * np.pi, 468, endpoint=False)
    landmarks = np.stack([96 + 60 * np.cos(theta), 100 + 75 * np.sin(theta),
                          np.zeros(468)], axis=1)
    outs = []
    for blocks, ch in (((128, 128, 128), 1404), ((128,), 1)):
        y = x
        for i, cout in enumerate(blocks):
            y = _mesh_block(g, y, cout, 2 if i == 0 else 1)
        y = _mesh_block(g, g.conv(y, 32, k=1, act="PRelu"), 32)
        y = g.conv(y, ch, pad=0, act=None, gain=0.05)
        if ch == 1404:
            g.inits[g.nodes[-1].inputs[2]] = np.asarray(landmarks, np.float32).reshape(-1)
        outs.append(g.op("Flatten", [y], (1, ch), axis=1))
    return g.finish(path, outs, stats)


def mdx_graph(path: Optional[str], dims: Tuple[int, int] = KIM_VOCAL_2_DIMS,
              stats: Optional[dict] = None) -> Optional[str]:
    """MDX-Net's TFC-TDF U-Net (kuielab's ConvTDFNet as its vocals
    configuration gives it: 11 blocks, 3 convs a TFC, growth 32, 3x3, a TDF
    bottleneck of f / 8, no bias) at `dims` = (dim_f, dim_t), Kim_Vocal_2's
    by default: (1, 4, dim_f, dim_t) -> the same. A 1x1 conv to 32
    channels, the frequency axis moved last, 5 levels of [TFC (3 3x3 convs
    + ReLU), TDF (two products over frequency with BatchNorm + ReLU,
    added)] with a 2x2 stride-2 conv that adds 32 channels, a bottleneck
    block, 5 levels up by 2x2 transposed convs, each multiplied by its
    skip, and a 1x1 conv back to 4 channels. 185.5 G multiply-adds and
    10.9 M parameters at Kim_Vocal_2's dims."""
    f, t = dims
    g_ch = 32
    g = _Graph(3, {"x": [1, 4, f, t]})

    def tfc_tdf(x: str) -> str:
        for _ in range(3):
            x = g.conv(x, g.shape[x][1])
        n_f = g.shape[x][3]
        y = g.act(g.bn(g.matmul(x, n_f // 8)), "Relu")
        y = g.act(g.bn(g.matmul(y, n_f, gain=0.5)), "Relu")
        return g.binary("Add", x, y)

    x = g.conv("x", g_ch, k=1)
    n, c, h, w = g.shape[x]
    x = g.op("Transpose", [x], (n, c, w, h), perm=[0, 1, 3, 2])
    skips = []
    for _ in range(5):
        x = tfc_tdf(x)
        skips.append(x)
        x = g.conv(x, g.shape[x][1] + g_ch, k=2, stride=2, pad=0)
    x = tfc_tdf(x)
    for skip in reversed(skips):
        x = g.conv_transpose(x, g.shape[x][1] - g_ch, 2)
        x = tfc_tdf(g.binary("Mul", x, skip))
    n, c, h, w = g.shape[x]
    x = g.op("Transpose", [x], (n, c, w, h), perm=[0, 1, 3, 2])
    return g.finish(path, [g.conv(x, 4, k=1, act=None, gain=1.0)], stats)


def identity_mdx_graph(path: str, dims: Tuple[int, int] = KIM_VOCAL_2_DIMS) -> str:
    """An MDX-Net graph that gives its spectrogram back: (1, 4, dim_f,
    dim_t) -> the same, at Kim_Vocal_2's dims by default (the separator's
    round-trip check)."""
    f, t = dims
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    save_onnx(path, [_node("Identity", ["x"], ["y"])], {}, {"x": [1, 4, f, t]},
              {"y": [1, 4, f, t]})
    return path
