"""LPIPS (AlexNet variant) on PyTorch (counterpart of hallo_tpu/utils/lpips.py).

The standard LPIPS-alex distance (Zhang et al., CVPR 2018): a scaling layer
-> AlexNet's conv features at its five ReLU taps -> per-channel unit
normalisation -> learned 1x1 weights on the squared difference -> spatial
mean -> sum over the taps, on NCHW tensors with `F.conv2d` (JAX computes
these convs with `lax.conv`: no kernel of the port lies here).

No LPIPS weights ship in the repository. `load_lpips` looks for
`pretrained_models/lpips_alex.pth`, produced with
`torch.save(lpips.LPIPS(net='alex').state_dict(), path)` on any machine with
the `lpips` package; without it the metric is reported as skipped with the
reason. Divergence from JAX (`hallo_tpu/utils/lpips.py:144-148`): a file
that exists but fails to load raises here, where JAX returns (None, reason),
as every loader of the port does since the CLI's (a corrupt file is a fault,
not a missing option).

Reference surface: richzhang/PerceptualSimilarity lpips/lpips.py
(LPIPS.forward) and lpips/pretrained_networks.py (AlexNet slices over
torchvision `features` indices 0..11): conv1 64@11x11 s4 p2 | pool 3x3 s2 |
conv2 192@5x5 p2 | pool | conv3 384@3x3 p1 | conv4 256@3x3 p1 | conv5
256@3x3 p1, a tap after each ReLU.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# torchvision AlexNet `features` indices of the five convolutions; they
# appear verbatim in the lpips state-dict keys (net.slice{k}.{index}.weight).
CONV_INDICES = (0, 3, 6, 8, 10)
TAP_CHANNELS = (64, 192, 384, 256, 256)
CONV_KERNEL = (11, 5, 3, 3, 3)
# (stride, padding) per conv; 3x3 stride-2 VALID max-pools before convs 2/3
CONV_STRIDE = (4, 1, 1, 1, 1)
CONV_PAD = (2, 2, 1, 1, 1)
POOL_BEFORE = (False, True, True, False, False)

# ImageNet scaling layer (lpips/lpips.py ScalingLayer); inputs are RGB in [-1, 1]
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)

DEFAULT_WEIGHTS = "pretrained_models/lpips_alex.pth"
SKIP_REASON = (
    "LPIPS weights not found (expected pretrained_models/"
    "lpips_alex.pth = torch.save(lpips.LPIPS(net='alex')"
    ".state_dict())); metric skipped"
)
# frames a batch of `lpips_from_uint8`: AlexNet's largest activation at 512^2
# is conv1's 64 x 127 x 127 fp32 (4.1 MB a frame), so 16 frames at a time
# stay well under a GiB with both stacks' taps alive
FRAMES_PER_BATCH = 16

Params = Dict[str, List[Any]]


def convert_lpips_state_dict(state_dict: Mapping[str, Any]) -> Params:
    """`lpips.LPIPS(net='alex').state_dict()` -> {"convs": [{"weight" (OIHW),
    "bias"}], "lins": [(C,)]}, fp32 on the CPU. The conv weights keep torch's
    OIHW layout; each lin (1, C, 1, 1) flattens to (C,). Raises KeyError
    listing every missing key, so that a wrong file fails at load."""
    params: Params = {"convs": [], "lins": []}
    missing = []
    for k, idx in enumerate(CONV_INDICES):
        wk, bk = f"net.slice{k + 1}.{idx}.weight", f"net.slice{k + 1}.{idx}.bias"
        if wk not in state_dict or bk not in state_dict:
            missing.append(wk)
            continue
        params["convs"].append({
            "weight": torch.as_tensor(state_dict[wk]).detach().float().cpu(),
            "bias": torch.as_tensor(state_dict[bk]).detach().float().cpu(),
        })
    for k, c in enumerate(TAP_CHANNELS):
        lk = f"lin{k}.model.1.weight"
        if lk not in state_dict:
            missing.append(lk)
            continue
        lin = torch.as_tensor(state_dict[lk]).detach().float().cpu().reshape(-1)
        if lin.shape[0] != c:
            raise ValueError(f"{lk}: expected {c} channels, got {lin.shape[0]}")
        params["lins"].append(lin)
    if missing:
        raise KeyError(f"LPIPS state dict is missing keys: {missing}")
    return params


def random_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A structurally exact lpips-alex state dict with random weights from
    `seed` (PyTorch's default conv init, lins uniform in [0, 1)): the
    stand-in for the weights file where none ships."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    cin = 3
    for k, (idx, cout, ksz) in enumerate(zip(CONV_INDICES, TAP_CHANNELS, CONV_KERNEL)):
        bound = 1.0 / float(np.sqrt(cin * ksz * ksz))
        sd[f"net.slice{k + 1}.{idx}.weight"] = (
            torch.rand((cout, cin, ksz, ksz), generator=gen) * 2 - 1) * bound
        sd[f"net.slice{k + 1}.{idx}.bias"] = (torch.rand((cout,), generator=gen) * 2 - 1) * bound
        cin = cout
    for k, c in enumerate(TAP_CHANNELS):
        sd[f"lin{k}.model.1.weight"] = torch.rand((1, c, 1, 1), generator=gen)
    return sd


def to_device(params: Params, device: torch.device) -> Params:
    return {"convs": [{k: v.to(device) for k, v in conv.items()} for conv in params["convs"]],
            "lins": [lin.to(device) for lin in params["lins"]]}


def _alexnet_taps(params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """x: (B, 3, H, W) scaled input -> the five post-ReLU feature maps."""
    taps = []
    for k, conv in enumerate(params["convs"]):
        if POOL_BEFORE[k]:
            x = F.max_pool2d(x, 3, 2)
        x = F.relu(F.conv2d(x, conv["weight"], conv["bias"], stride=CONV_STRIDE[k],
                            padding=CONV_PAD[k]))
        taps.append(x)
    return taps


def lpips_distance(params: Params, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LPIPS-alex distance per batch element. a, b: (B, 3, H, W) RGB in
    [-1, 1] on the device of `params`. Returns (B,) fp32."""
    dev = params["lins"][0].device
    shift = torch.tensor(SHIFT, device=dev).view(1, 3, 1, 1)
    scale = torch.tensor(SCALE, device=dev).view(1, 3, 1, 1)

    def feats(x):
        x = (x.float() - shift) / scale
        return [t / torch.sqrt((t * t).sum(1, keepdim=True) + 1e-10)
                for t in _alexnet_taps(params, x)]

    fa, fb = feats(a), feats(b)
    total = 0.0
    for k, lin in enumerate(params["lins"]):
        d = (fa[k] - fb[k]) ** 2
        total = total + (d * lin.view(1, -1, 1, 1)).sum(1).mean((1, 2))
    return total


def load_lpips(path: Optional[str] = None) -> Tuple[Optional[Params], str]:
    """LPIPS params from a torch .pth, or (None, reason) when no file exists.

    Looks at `path`, $HALLO_LPIPS_WEIGHTS, `DEFAULT_WEIGHTS` under the
    working directory, then under the repository's root. A file that exists
    but fails to load raises (the module docstring's divergence)."""
    candidates = [
        path,
        os.environ.get("HALLO_LPIPS_WEIGHTS"),
        DEFAULT_WEIGHTS,
        os.path.join(os.path.dirname(__file__), "..", "..", DEFAULT_WEIGHTS),
    ]
    found = next((c for c in candidates if c and os.path.exists(c)), None)
    if found is None:
        return None, SKIP_REASON
    sd = torch.load(found, map_location="cpu", weights_only=True)
    return convert_lpips_state_dict(sd), f"loaded {found}"


@torch.inference_mode()
def lpips_from_uint8(params: Params, a: np.ndarray, b: np.ndarray,
                     device: torch.device = torch.device("cuda")) -> float:
    """Mean LPIPS between two uint8 frame stacks (..., H, W, 3), computed on
    `device` (the card unless the caller asks for another) in batches of
    `FRAMES_PER_BATCH` frames, with TF32 off."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("lpips_from_uint8: no CUDA device; pass device='cpu' for the CPU")
    a = np.asarray(a).reshape(-1, *np.shape(a)[-3:])
    b = np.asarray(b).reshape(-1, *np.shape(b)[-3:])
    if a.shape != b.shape:
        raise ValueError(f"frame stacks differ: {a.shape} vs {b.shape}")
    p = to_device(params, device)

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        return t.permute(0, 3, 1, 2).float() / 127.5 - 1.0

    # fp32 convolutions in full fp32, as JAX's metric: cuDNN would run them
    # in TF32 by default
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        dists = [lpips_distance(p, put(a[i:i + FRAMES_PER_BATCH]),
                                put(b[i:i + FRAMES_PER_BATCH]))
                 for i in range(0, a.shape[0], FRAMES_PER_BATCH)]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return float(torch.cat(dists).mean())
