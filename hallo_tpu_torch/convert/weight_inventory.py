"""Static key+shape inventories for the pretrained checkpoints hallo loads.

The port's copy of hallo_tpu/convert/weight_inventory.py and its JSON (the
port imports nothing of the JAX package); `convert.load_pretrained`,
`preflight_weights` and the tests of the port read it.

The environment has none of the real weight files, so the converter
(`torch_to_jax.py`) can only be oracle-tested against locally built torch
modules. These inventories pin the *complete* key list + tensor shape of
each production checkpoint as a static contract (same pattern as
`onnx_inventory.py` for the ONNX models), so `tests/test_weight_inventory.py`
can assert — without any weights on disk — that:

  1. the converter maps 100% of each checkpoint's keys to flax paths
     (or an explicitly documented skip), and
  2. every flax param leaf of the full-width models is sourced by some
     checkpoint key with the exact post-transform shape (or is on the
     documented random-init list).

Sources for the enumerations (all structural, derived from the reference's
model definitions, not copied weights):
  - SD-1.5 UNet: diffusers UNet2DConditionModel at the SD-1.5 config
    (block_out_channels (320,640,1280,1280), layers_per_block 2, heads 8,
    cross_attention_dim 768) — the structure the reference vendors in
    hallo/models/unet_2d_condition.py / unet_2d_blocks.py. The enumerated
    key count (686) matches the published checkpoint's tensor count.
  - sd-vae-ft-mse: diffusers AutoencoderKL ((128,256,512,512)x2 layers,
    modern to_q/to_k/to_v attention naming). Count (248) matches the
    published checkpoint.
  - AnimateDiff mm_sd_v15_v2.ckpt: hallo/models/motion_module.py:126-316
    (21 VanillaTemporalModules: 2/down-block, 3/up-block, 1 mid;
    PE max_len 32 for v2).
  - denoising 3D UNet (inside hallo net.pth): hallo/models/unet_3d.py +
    unet_3d_blocks.py — the SD-1.5 spatial skeleton (same key names, conv_in
    at 4 channels) plus audio_modules (with the inner-dim quirk of
    unet_3d_blocks.py:586-605: inner = the block-constructor `in_channels`
    var, NOT the module's channel count) and motion_modules.
  - net.pth: scripts/inference.py:51-94 `Net` attribute prefixes.
  - wav2vec2-base-960h: transformers Wav2Vec2Model at the base config
    (generated via `scripts/gen_wav2vec_inventory.py` into
    wav2vec2_base_inventory.json; the published file uses weight_g/weight_v
    for the weight-normed pos_conv, recorded as such).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

Shape = Tuple[int, ...]
Inventory = Dict[str, Shape]

SD15_BLOCK_CHANNELS = (320, 640, 1280, 1280)
SD15_LAYERS = 2
SD15_CROSS = 768
SD15_TEMB = 1280
AUDIO_CROSS = 768  # audio_attention_dim, default.yaml:69
MM_MAX_LEN = 32  # mm_sd_v15_v2 positional-encoding length


class _Inv:
    def __init__(self) -> None:
        self.d: Inventory = {}

    def add(self, key: str, shape: Shape) -> None:
        assert key not in self.d, key
        self.d[key] = tuple(int(s) for s in shape)

    def conv(self, name: str, o: int, i: int, k: int = 3) -> None:
        self.add(f"{name}.weight", (o, i, k, k))
        self.add(f"{name}.bias", (o,))

    def norm(self, name: str, c: int) -> None:
        self.add(f"{name}.weight", (c,))
        self.add(f"{name}.bias", (c,))

    def dense(self, name: str, o: int, i: int, bias: bool = True) -> None:
        self.add(f"{name}.weight", (o, i))
        if bias:
            self.add(f"{name}.bias", (o,))

    def resnet(self, base: str, cin: int, cout: int, temb: int | None = SD15_TEMB) -> None:
        self.norm(f"{base}.norm1", cin)
        self.conv(f"{base}.conv1", cout, cin)
        if temb is not None:
            self.dense(f"{base}.time_emb_proj", cout, temb)
        self.norm(f"{base}.norm2", cout)
        self.conv(f"{base}.conv2", cout, cout)
        if cin != cout:
            self.conv(f"{base}.conv_shortcut", cout, cin, k=1)

    def attention(self, base: str, q: int, kv: int, qkv_bias: bool = False) -> None:
        self.dense(f"{base}.to_q", q, q, qkv_bias)
        self.dense(f"{base}.to_k", q, kv, qkv_bias)
        self.dense(f"{base}.to_v", q, kv, qkv_bias)
        self.dense(f"{base}.to_out.0", q, q)

    def ff(self, base: str, c: int) -> None:
        # GEGLU: net.0.proj doubles the 4x inner dim
        self.dense(f"{base}.net.0.proj", 8 * c, c)
        self.dense(f"{base}.net.2", c, 4 * c)

    def basic_transformer_block(self, base: str, c: int, cross: int) -> None:
        """BasicTransformerBlock / TemporalBasicTransformerBlock params
        (attention.py:79-407, 410-530; no attn_temp in production —
        unet_use_temporal_attention: false)."""
        self.norm(f"{base}.norm1", c)
        self.attention(f"{base}.attn1", c, c)
        self.norm(f"{base}.norm2", c)
        self.attention(f"{base}.attn2", c, cross)
        self.norm(f"{base}.norm3", c)
        self.ff(f"{base}.ff", c)

    def spatial_transformer(self, base: str, c: int, cross: int) -> None:
        """Transformer2D/3D wrapper, use_linear_projection=False -> 1x1 convs."""
        self.norm(f"{base}.norm", c)
        self.conv(f"{base}.proj_in", c, c, k=1)
        self.basic_transformer_block(f"{base}.transformer_blocks.0", c, cross)
        self.conv(f"{base}.proj_out", c, c, k=1)

    def audio_transformer(self, base: str, c: int, inner: int) -> None:
        """Audio Transformer3DModel: wrapper at channel c, the inner
        AudioTemporalBasicTransformerBlock at `inner` (the quirk:
        unet_3d_blocks.py:586-605 passes the *constructor* in_channels//heads
        as head_dim, so inner != c wherever block input != block output).
        All production audio blocks are 3-branch (stack_enable covers every
        name/depth, default.yaml:70-73)."""
        self.norm(f"{base}.norm", c)
        self.add(f"{base}.proj_in.weight", (inner, c, 1, 1))
        self.add(f"{base}.proj_in.bias", (inner,))
        blk = f"{base}.transformer_blocks.0"
        for zc in ("zero_conv_full", "zero_conv_face", "zero_conv_lip"):
            self.add(f"{blk}.{zc}.weight", (inner, inner, 1, 1))
            self.add(f"{blk}.{zc}.bias", (inner,))
        self.norm(f"{blk}.norm1", inner)
        self.attention(f"{blk}.attn1", inner, inner)
        self.norm(f"{blk}.norm2", inner)
        for a in ("attn2_0", "attn2_1", "attn2_2"):
            self.attention(f"{blk}.{a}", inner, AUDIO_CROSS)
        self.norm(f"{blk}.norm3", inner)
        self.ff(f"{blk}.ff", inner)
        self.add(f"{base}.proj_out.weight", (c, inner, 1, 1))
        self.add(f"{base}.proj_out.bias", (c,))

    def motion_module(self, base: str, c: int, max_len: int = MM_MAX_LEN) -> None:
        """VanillaTemporalModule.temporal_transformer (motion_module.py:
        126-316): 1 block, 2 Temporal_Self attention blocks, dim_div 1."""
        tt = f"{base}.temporal_transformer"
        self.norm(f"{tt}.norm", c)
        self.dense(f"{tt}.proj_in", c, c)
        blk = f"{tt}.transformer_blocks.0"
        for a in range(2):
            self.attention(f"{blk}.attention_blocks.{a}", c, c)
            self.add(f"{blk}.attention_blocks.{a}.pos_encoder.pe", (1, max_len, c))
            self.norm(f"{blk}.norms.{a}", c)
        self.ff(f"{blk}.ff", c)
        self.norm(f"{blk}.ff_norm", c)
        self.dense(f"{tt}.proj_out", c, c)


def _unet_spatial(inv: _Inv, in_channels: int) -> None:
    """The SD-1.5 UNet2DConditionModel key skeleton (shared verbatim by the
    2D ReferenceNet and the 3D denoiser's spatial weights — InflatedConv3d
    is an nn.Conv2d, resnet.py:30-66, so shapes coincide)."""
    B, L = SD15_BLOCK_CHANNELS, SD15_LAYERS
    inv.conv("conv_in", B[0], in_channels)
    inv.dense("time_embedding.linear_1", SD15_TEMB, B[0])
    inv.dense("time_embedding.linear_2", SD15_TEMB, SD15_TEMB)
    for i in range(4):
        block_cin = B[i - 1] if i > 0 else B[0]
        for j in range(L):
            cin = block_cin if j == 0 else B[i]
            inv.resnet(f"down_blocks.{i}.resnets.{j}", cin, B[i])
            if i < 3:
                inv.spatial_transformer(
                    f"down_blocks.{i}.attentions.{j}", B[i], SD15_CROSS
                )
        if i < 3:
            inv.conv(f"down_blocks.{i}.downsamplers.0.conv", B[i], B[i])
    inv.resnet("mid_block.resnets.0", B[3], B[3])
    inv.spatial_transformer("mid_block.attentions.0", B[3], SD15_CROSS)
    inv.resnet("mid_block.resnets.1", B[3], B[3])
    rev = B[::-1]
    prev = B[-1]
    for i in range(4):
        out = rev[i]
        inp = rev[min(i + 1, 3)]
        for j in range(L + 1):
            skip = inp if j == L else out
            rin = prev if j == 0 else out
            inv.resnet(f"up_blocks.{i}.resnets.{j}", rin + skip, out)
            if i > 0:
                inv.spatial_transformer(
                    f"up_blocks.{i}.attentions.{j}", out, SD15_CROSS
                )
        if i < 3:
            inv.conv(f"up_blocks.{i}.upsamplers.0.conv", out, out)
        prev = out
    inv.norm("conv_norm_out", B[0])
    inv.conv("conv_out", 4, B[0])


def sd15_unet_inventory(in_channels: int = 4) -> Inventory:
    """stable-diffusion-v1-5/unet/diffusion_pytorch_model.safetensors
    (686 tensors)."""
    inv = _Inv()
    _unet_spatial(inv, in_channels)
    return inv.d


def sd_vae_inventory() -> Inventory:
    """sd-vae-ft-mse/diffusion_pytorch_model.safetensors (248 tensors,
    modern diffusers attention naming)."""
    inv = _Inv()
    B = (128, 256, 512, 512)

    # encoder
    inv.conv("encoder.conv_in", B[0], 3)
    for i in range(4):
        block_cin = B[i - 1] if i > 0 else B[0]
        for j in range(2):
            cin = block_cin if j == 0 else B[i]
            inv.resnet(f"encoder.down_blocks.{i}.resnets.{j}", cin, B[i], temb=None)
        if i < 3:
            inv.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", B[i], B[i])
    inv.resnet("encoder.mid_block.resnets.0", B[3], B[3], temb=None)
    inv.norm("encoder.mid_block.attentions.0.group_norm", B[3])
    inv.attention("encoder.mid_block.attentions.0", B[3], B[3], qkv_bias=True)
    inv.resnet("encoder.mid_block.resnets.1", B[3], B[3], temb=None)
    inv.norm("encoder.conv_norm_out", B[3])
    inv.conv("encoder.conv_out", 8, B[3])  # 2 * latent (mean, logvar)
    inv.conv("quant_conv", 8, 8, k=1)

    # decoder
    inv.conv("post_quant_conv", 4, 4, k=1)
    inv.conv("decoder.conv_in", B[3], 4)
    inv.resnet("decoder.mid_block.resnets.0", B[3], B[3], temb=None)
    inv.norm("decoder.mid_block.attentions.0.group_norm", B[3])
    inv.attention("decoder.mid_block.attentions.0", B[3], B[3], qkv_bias=True)
    inv.resnet("decoder.mid_block.resnets.1", B[3], B[3], temb=None)
    rev = B[::-1]  # (512, 512, 256, 128)
    prev = B[3]
    for i in range(4):
        out = rev[i]
        for j in range(3):
            cin = prev if j == 0 else out
            inv.resnet(f"decoder.up_blocks.{i}.resnets.{j}", cin, out, temb=None)
        if i < 3:
            inv.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", out, out)
        prev = out
    inv.norm("decoder.conv_norm_out", B[0])
    inv.conv("decoder.conv_out", 3, B[0])
    return inv.d


def _denoiser_extras(inv: _Inv, audio: bool, motion: bool) -> None:
    """audio_modules + motion_modules of the 3D denoiser (the layout the
    AnimateDiff ckpt and net.pth's denoising_unet.* keys share)."""
    B, L = SD15_BLOCK_CHANNELS, SD15_LAYERS
    for i in range(4):
        block_cin = B[i - 1] if i > 0 else B[0]
        for j in range(L):
            layer_cin = block_cin if j == 0 else B[i]
            if audio and i < 3:  # CrossAttnDownBlock3D only
                # quirk: inner follows the loop-local in_channels var
                # (unet_3d_blocks.py:560,586-588)
                inv.audio_transformer(
                    f"down_blocks.{i}.audio_modules.{j}", B[i], layer_cin
                )
            if motion:
                inv.motion_module(f"down_blocks.{i}.motion_modules.{j}", B[i])
    if audio:
        inv.audio_transformer("mid_block.audio_modules.0", B[3], B[3])
    if motion:
        inv.motion_module("mid_block.motion_modules.0", B[3])
    rev = B[::-1]
    for i in range(4):
        out = rev[i]
        inp = rev[min(i + 1, 3)]
        for j in range(L + 1):
            if audio and i > 0:  # CrossAttnUpBlock3D only
                # quirk: the up-block constructor's in_channels (the skip
                # width, never reassigned) sets inner for ALL its layers
                # (unet_3d_blocks.py:1048-1051)
                inv.audio_transformer(
                    f"up_blocks.{i}.audio_modules.{j}", out, inp
                )
            if motion:
                inv.motion_module(f"up_blocks.{i}.motion_modules.{j}", out)


def animatediff_mm_inventory() -> Inventory:
    """mm_sd_v15_v2.ckpt: the 21 motion modules (8 down, 1 mid, 12 up),
    588 tensors incl. the pos_encoder.pe buffers (skipped by the converter:
    fixed sinusoid)."""
    inv = _Inv()
    _denoiser_extras(inv, audio=False, motion=True)
    return inv.d


def denoising_unet_inventory() -> Inventory:
    """The full 3D denoiser state dict (net.pth's denoising_unet.* keys):
    SD-1.5 spatial skeleton + audio modules + motion modules."""
    inv = _Inv()
    _unet_spatial(inv, in_channels=4)
    _denoiser_extras(inv, audio=True, motion=True)
    return inv.d


def face_locator_inventory() -> Inventory:
    """FaceLocator (face_locator.py:34-92): conv_in, 6 interleaved convs,
    zero conv_out to 320 channels."""
    inv = _Inv()
    B = (16, 32, 64, 128)
    inv.conv("conv_in", B[0], 3)
    k = 0
    for i in range(3):
        inv.conv(f"blocks.{k}", B[i], B[i]); k += 1
        inv.conv(f"blocks.{k}", B[i + 1], B[i]); k += 1
    inv.conv("conv_out", 320, B[3])
    return inv.d


def image_proj_inventory() -> Inventory:
    """ImageProjModel (image_proj.py:23-76): ArcFace 512 -> 4x768 tokens."""
    inv = _Inv()
    inv.dense("proj", 4 * 768, 512)
    inv.norm("norm", 768)
    return inv.d


def audio_proj_inventory() -> Inventory:
    """AudioProjModel (audio_proj.py:40-124): (5,12,768) window -> 32x768."""
    inv = _Inv()
    inv.dense("proj1", 512, 5 * 12 * 768)
    inv.dense("proj2", 512, 512)
    inv.dense("proj3", 32 * 768, 512)
    inv.norm("norm", 768)
    return inv.d


def net_pth_inventory() -> Inventory:
    """hallo net.pth: the fused Net state dict (scripts/inference.py:51-94)."""
    out: Inventory = {}
    for prefix, inv in (
        ("reference_unet", sd15_unet_inventory(4)),
        ("denoising_unet", denoising_unet_inventory()),
        ("face_locator", face_locator_inventory()),
        ("imageproj", image_proj_inventory()),
        ("audioproj", audio_proj_inventory()),
    ):
        for k, v in inv.items():
            out[f"{prefix}.{k}"] = v
    return out


_W2V_JSON = os.path.join(os.path.dirname(__file__), "wav2vec2_base_inventory.json")


def wav2vec2_inventory() -> Inventory:
    """facebook/wav2vec2-base-960h pytorch_model.bin keys+shapes, generated
    from transformers' Wav2Vec2Model at the base config
    (scripts/gen_wav2vec_inventory.py) and frozen here."""
    with open(_W2V_JSON) as f:
        return {k: tuple(v) for k, v in json.load(f).items()}


ALL_INVENTORIES = {
    "sd15_unet": sd15_unet_inventory,
    "sd_vae_ft_mse": sd_vae_inventory,
    "animatediff_mm_sd_v15_v2": animatediff_mm_inventory,
    "net_pth": net_pth_inventory,
    "wav2vec2_base_960h": wav2vec2_inventory,
}
