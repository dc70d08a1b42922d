"""The frozen reference of the measured models, in plain PyTorch: the
denoising video UNet with its ReferenceNet, motion and hierarchical audio
modules, the SD VAE, the face locator and the two projection heads of Hallo
(fudan-generative-vision/hallo, over SD-1.5's UNet), as the benchmark's
configuration files give their sizes. Parameter names are the reference
checkpoints' (diffusers keys), so one state dict loads here and into the
measured program alike. Video tensors are (B, F, C, H, W); images NCHW.

The denoiser's two CFG halves are computed as what they mean, one after the
other: the unconditional half attends to its own tokens only (no reference
tokens), with zero audio tokens and no face condition; the conditional half
attends to its tokens and the reference tokens.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from benchmark.reference.nn import (
    Attention, Conv1x1Tokens, Conv2d, FeedForward, GroupNorm, LayerNorm, Linear,
    TimestepEmbedding, attention, planning, sinusoidal_positions, timestep_embedding)

Feats = Dict[str, List[torch.Tensor]]


def _fold(x):
    return x.flatten(0, 1)


def _unfold(x, f):
    return x.unflatten(0, (-1, f))


def _tokens(x):
    return x.flatten(2).transpose(1, 2)


def _image(t, h, w):
    return t.transpose(1, 2).unflatten(2, (h, w))


class Resnet(nn.Module):
    """GN -> SiLU -> conv (+ temb) -> GN -> SiLU -> conv, + shortcut, on video;
    `inflated`: GroupNorm statistics over (F, H, W), else per frame."""

    def __init__(self, cin, cout, temb, groups, eps, inflated):
        super().__init__()
        self.inflated = inflated
        self.norm1 = GroupNorm(groups, cin, eps=eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = Linear(temb, cout)
        self.norm2 = GroupNorm(groups, cout, eps=eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv2d(cin, cout, 1)

    def _norm(self, norm, x):
        return norm(x, inflated=True) if self.inflated else _unfold(norm(_fold(x)), x.shape[1])

    def forward(self, x, temb):
        f = x.shape[1]
        h = _unfold(self.conv1(_fold(F.silu(self._norm(self.norm1, x)))), f)
        h = h + self.time_emb_proj(F.silu(temb))[:, None, :, None, None]
        h = _unfold(self.conv2(_fold(F.silu(self._norm(self.norm2, h)))), f)
        if hasattr(self, "conv_shortcut"):
            x = _unfold(self.conv_shortcut(_fold(x)), f)
        return x + h


class Downsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return _unfold(self.conv(_fold(x)), x.shape[1])


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        f = x.shape[1]
        return _unfold(self.conv(F.interpolate(_fold(x), scale_factor=2.0, mode="nearest")), f)


class TransformerBlock(nn.Module):
    """norm1 / attn1 / norm2 / attn2 / norm3 / ff."""

    def __init__(self, dim, heads, context_dim):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim // heads)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dim // heads, context_dim=context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)


class SpatialTransformer(nn.Module):
    """GN -> 1x1 proj_in -> block -> 1x1 proj_out + residual. As the
    ReferenceNet's stage it returns the block's norm1 output (the reference
    feature); as the denoiser's it appends `ref` (B, Lr, C) to the keys of
    its self-attention."""

    def __init__(self, ch, heads, context_dim, groups):
        super().__init__()
        self.norm = GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = Conv1x1Tokens(ch, ch)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(ch, heads, context_dim)])
        self.proj_out = Conv1x1Tokens(ch, ch)

    def forward(self, x, context, ref=None, write=False):
        """x (N, C, H, W); context (N, T, D); ref (N, Lr, C) or None."""
        h, w = x.shape[-2:]
        blk = self.transformer_blocks[0]
        hs = self.proj_in(_tokens(self.norm(x)))
        normed = blk.norm1(hs)
        kv = normed if ref is None else torch.cat([normed, ref], dim=1)
        hs = hs + blk.attn1(normed, kv)
        hs = hs + blk.attn2(blk.norm2(hs), context)
        hs = hs + blk.ff(blk.norm3(hs))
        out = _image(self.proj_out(hs), h, w) + x
        return (out, normed) if write else out


class AudioTransformer(nn.Module):
    """GN -> proj_in (C -> inner) -> self-attention -> three masked audio
    cross-attentions (full, face, lip), each through its zero conv and
    scaled -> ff -> proj_out + residual."""

    BRANCHES = (("attn2_0", "zero_conv_full"), ("attn2_1", "zero_conv_face"),
                ("attn2_2", "zero_conv_lip"))

    def __init__(self, ch, heads, inner, audio_dim, groups):
        super().__init__()
        self.norm = GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = Conv1x1Tokens(ch, inner)
        blk = nn.Module()
        blk.norm1 = LayerNorm(inner)
        blk.attn1 = Attention(inner, heads, inner // heads)
        blk.norm2 = LayerNorm(inner)
        for attn_name, zc_name in self.BRANCHES:
            setattr(blk, attn_name, Attention(inner, heads, inner // heads,
                                              context_dim=audio_dim))
            setattr(blk, zc_name, Conv1x1Tokens(inner, inner))
        blk.norm3 = LayerNorm(inner)
        blk.ff = FeedForward(inner)
        self.transformer_blocks = nn.ModuleList([blk])
        self.proj_out = Conv1x1Tokens(inner, ch)

    def forward(self, x, audio, masks, scale, zero_audio=False):
        """x (N, C, H, W); audio (N, T, Da); masks 3 x (N, L); scale (3,)."""
        h, w = x.shape[-2:]
        blk = self.transformer_blocks[0]
        hs = self.proj_in(_tokens(self.norm(x)))
        hs = hs + blk.attn1(blk.norm1(hs))
        normed = blk.norm2(hs)
        acc = 0
        for (attn_name, zc_name), mask, s in zip(self.BRANCHES, masks, scale):
            attn = getattr(blk, attn_name)
            if zero_audio and planning():
                # all-zero context: softmax is uniform over zero values, so
                # the branch is to_out's bias; the program computes it on
                # one token
                o = attn(normed[:1, :1], audio[:1, :1])
                o = o.expand(normed.shape[0], normed.shape[1], -1)
            else:
                o = attn(normed, audio)
            acc = acc + s * getattr(blk, zc_name)(o * mask[:, :, None])
        hs = hs + acc
        hs = hs + blk.ff(blk.norm3(hs))
        return _image(self.proj_out(hs), h, w) + x


class TemporalBlock(nn.Module):
    def __init__(self, dim, heads, n_attn, max_len, use_pe):
        super().__init__()
        self.max_len, self.use_pe, self.heads = max_len, use_pe, heads
        self.attention_blocks = nn.ModuleList([
            Attention(dim, heads, dim // heads) for _ in range(n_attn)])
        self.norms = nn.ModuleList([LayerNorm(dim) for _ in range(n_attn)])
        self.ff = FeedForward(dim)
        self.ff_norm = LayerNorm(dim)

    def forward(self, hs):
        """hs (B, T, L, C): attention over T at every site L."""
        b, t, l, c = hs.shape
        for attn, norm in zip(self.attention_blocks, self.norms):
            z = norm(hs)
            if self.use_pe:
                z = z + sinusoidal_positions(self.max_len, c, hs.device)[:t][None, :, None]
            seq = z.permute(0, 2, 1, 3).reshape(b * l, t, c)
            out = attention(attn.to_q(seq), attn.to_k(seq), attn.to_v(seq), attn.heads,
                            kind="temporal")
            hs = hs + attn.to_out[0](out).reshape(b, l, t, c).permute(0, 2, 1, 3)
        return hs + self.ff(self.ff_norm(hs))


class MotionModule(nn.Module):
    """temporal_transformer: per-frame GN -> proj_in -> temporal blocks over
    [motion frames, clip frames] -> the clip's frames -> proj_out + residual."""

    def __init__(self, ch, mm):
        super().__init__()
        heads = mm["num_attention_heads"]
        inner = heads * (ch // heads // mm["temporal_attention_dim_div"])
        tt = nn.Module()
        tt.norm = GroupNorm(mm["norm_num_groups"], ch, eps=1e-6)
        tt.proj_in = Linear(ch, inner)
        tt.transformer_blocks = nn.ModuleList([
            TemporalBlock(inner, heads, len(mm["attention_block_types"]),
                          mm["temporal_position_encoding_max_len"],
                          mm["temporal_position_encoding"])
            for _ in range(mm["num_transformer_block"])])
        tt.proj_out = Linear(inner, ch)
        self.temporal_transformer = tt

    def forward(self, x, motion=None):
        """x (B, F, C, H, W); motion (B, M, L, C) ReferenceNet features of the
        motion frames, or None."""
        tt = self.temporal_transformer
        b, f, c, h, w = x.shape

        def prep(z):
            zn = _unfold(tt.norm(_fold(z)), z.shape[1])
            return tt.proj_in(zn.flatten(3).transpose(2, 3))

        hs = prep(x)
        m = 0
        if motion is not None and motion.shape[1] > 0:
            m = motion.shape[1]
            hs = torch.cat([prep(motion.transpose(2, 3).unflatten(3, (h, w))), hs], dim=1)
        for blk in tt.transformer_blocks:
            hs = blk(hs)
        hs = tt.proj_out(hs[:, m:])
        return x + hs.transpose(2, 3).unflatten(3, (h, w))


def skip_channels(ch: Sequence[int], lpb: int) -> List[int]:
    out = [ch[0]]
    for i in range(len(ch)):
        out += [ch[i]] * lpb
        if i < len(ch) - 1:
            out.append(ch[i])
    return out


def up_skip_channels(ch: Sequence[int], lpb: int, n_up: int) -> List[List[int]]:
    stack = skip_channels(ch, lpb)
    return [[stack.pop() for _ in range(lpb + 1)] for _ in range(n_up)]


class Stage(nn.Module):
    """One UNet stage: resnets [+ attentions] [+ audio_modules]
    [+ motion_modules] [+ downsamplers | upsamplers]."""

    def __init__(self, ins, out, u, attn, audio_inner, motion, n_attn=None, inflated=True,
                 sampler=None):
        super().__init__()
        n = len(ins) if n_attn is None else n_attn
        heads, groups = u["num_attention_heads"], u["norm_num_groups"]
        temb = u["block_out_channels"][0] * 4
        self.resnets = nn.ModuleList([Resnet(c, out, temb, groups, u["norm_eps"], inflated)
                                      for c in ins])
        if attn:
            self.attentions = nn.ModuleList([
                SpatialTransformer(out, heads, u["cross_attention_dim"], groups)
                for _ in range(n)])
        if audio_inner is not None:
            self.audio_modules = nn.ModuleList([
                AudioTransformer(out, heads, i, u["audio_attention_dim"], groups)
                for i in audio_inner])
        if motion is not None:
            self.motion_modules = nn.ModuleList([MotionModule(out, motion) for _ in range(n)])
        if sampler == "down":
            self.downsamplers = nn.ModuleList([Downsample(out)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([Upsample(out)])


def _layout(u: dict, video: bool):
    """Per stage (name, ins, out, attention, audio inners, motion, sampler)."""
    ch, lpb = u["block_out_channels"], u["layers_per_block"]
    heads = u["num_attention_heads"]
    mm = u["motion_module"] if (video and u["use_motion_module"]) else None
    res = u["motion_module_resolutions"]
    n = len(ch)

    def audio(attn, inners):
        if not (video and u["use_audio_module"] and attn):
            return None
        return [(c // heads) * heads for c in inners]

    out = []
    for i, kind in enumerate(u["down_block_types"]):
        attn = kind.startswith("CrossAttn")
        cin = ch[i - 1] if i > 0 else ch[0]
        use_mm = (mm is not None and 2 ** i in res and not u["motion_module_decoder_only"])
        out.append((f"down_{i}", [cin] + [ch[i]] * (lpb - 1), ch[i], attn,
                    audio(attn, [cin] + [ch[i]] * (lpb - 1)), mm if use_mm else None,
                    "down" if i < n - 1 else None))
    out.append(("mid", [ch[-1], ch[-1]], ch[-1], True, audio(True, [ch[-1]]),
                mm if (mm is not None and u["motion_module_mid_block"]) else None, None))
    rev = tuple(reversed(ch))
    for i, (kind, skips) in enumerate(zip(u["up_block_types"],
                                          up_skip_channels(ch, lpb, len(u["up_block_types"])))):
        attn = kind.startswith("CrossAttn")
        prev = rev[i - 1] if i > 0 else ch[-1]
        use_mm = mm is not None and 2 ** (3 - i) in res
        out.append((f"up_{i}", [(prev if j == 0 else rev[i]) + s for j, s in enumerate(skips)],
                    rev[i], attn, audio(attn, [rev[min(i + 1, n - 1)]] * len(skips)),
                    mm if use_mm else None, "up" if i < n - 1 else None))
    return out


class _UNet(nn.Module):
    def __init__(self, u: dict, video: bool):
        super().__init__()
        self.u = u
        ch = u["block_out_channels"]
        self.conv_in = Conv2d(u["in_channels"], ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], ch[0] * 4)
        self.down_blocks, self.up_blocks = nn.ModuleList(), nn.ModuleList()
        self.names = []
        for name, ins, out, attn, ainner, mm, sampler in _layout(u, video):
            kw = dict(n_attn=1) if name == "mid" else {}
            stage = Stage(ins, out, u, attn, ainner, mm, inflated=video and u.get(
                "use_inflated_groupnorm", True), sampler=sampler, **kw)
            if name == "mid":
                self.mid_block = stage
            else:
                (self.down_blocks if name.startswith("down") else self.up_blocks).append(stage)
            self.names.append(name)
        self.conv_norm_out = GroupNorm(u["norm_num_groups"], ch[0], eps=u["norm_eps"])
        self.conv_out = Conv2d(ch[0], u["out_channels"], 3, padding=1)

    def temb(self, t, n):
        t = torch.as_tensor(t, device=self.conv_in.weight.device)
        t = t.expand(n) if t.ndim == 0 else t
        e = timestep_embedding(t, self.u["block_out_channels"][0], self.u["flip_sin_to_cos"],
                               self.u["freq_shift"])
        return self.time_embedding(e.to(self.conv_in.weight.dtype))

    def stages(self):
        return list(self.down_blocks) + [self.mid_block] + list(self.up_blocks)


class ReferenceNet(_UNet):
    """The 2D UNet whose spatial stages write the reference features."""

    def __init__(self, u: dict):
        super().__init__(u, video=False)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> Feats:
        """x (N, 4, h, w) latents at t = 0; context (N, T, D). Returns the
        norm1 outputs of every spatial stage, by stage name."""
        temb = self.temb(0, x.shape[0])
        x = self.conv_in(x)[:, None]  # a one-frame video
        feats: Feats = {}
        skips = [x]
        for name, st in zip(self.names, self.stages()):
            up = name.startswith("up")
            for j, res in enumerate(st.resnets):
                if up:
                    x = torch.cat([x, skips.pop()], dim=2)
                x = res(x, temb)
                if hasattr(st, "attentions") and j < len(st.attentions):
                    y, f = st.attentions[j](x[:, 0], context, write=True)
                    x = y[:, None]
                    feats.setdefault(name, []).append(f)
                if name.startswith("down"):
                    skips.append(x)
            if hasattr(st, "downsamplers"):
                x = st.downsamplers[0](x)
                skips.append(x)
            if hasattr(st, "upsamplers"):
                x = st.upsamplers[0](x)
        return feats


class DenoisingUNet(_UNet):
    def __init__(self, u: dict):
        super().__init__(u, video=True)

    checkpoint = False  # recompute each layer in the backward pass (memory)

    def _layer(self, st, name, j, x, temb, context_f, r, audio, lvl, motion_scale, mf,
               uncond):
        x = st.resnets[j](x, temb)
        f = x.shape[1]
        if hasattr(st, "attentions"):
            x = _unfold(st.attentions[j](_fold(x), context_f, r), f)
        if hasattr(st, "audio_modules"):
            x = _unfold(st.audio_modules[j](_fold(x), audio, lvl, motion_scale,
                                            zero_audio=uncond), f)
        if hasattr(st, "motion_modules"):
            x = st.motion_modules[j](x, mf)
        return x

    def forward(self, sample, t, context, ref: Optional[Feats], motion: Optional[Feats],
                audio, face_cond, masks, motion_scale, uncond: bool, fusion: str = "mid"):
        """One CFG half. sample (B, F, 4, h, w); t scalar or (B,); context
        (B, T, D); ref: per-stage (B, L, C) reference features, None where
        the reference tokens are dropped (the unconditional half); motion:
        per-stage (B, M, L, C) motion-frame features, used where `fusion`
        says ("mid" at inference, "all" in training); audio (B, F, Ta, Da);
        face_cond (B, F, C0, h, w) or None; masks per depth (full, face,
        lip) each (B*F, L); motion_scale (3,). `uncond`: the audio context
        is all zero (for the FLOP plan only)."""
        b, f = sample.shape[:2]
        temb = self.temb(t, b)
        x = _unfold(self.conv_in(_fold(sample)), f)
        if face_cond is not None:
            x = x + face_cond
        audio = audio.flatten(0, 1)
        context_f = context.repeat_interleave(f, dim=0)
        skips = [x]
        remat = self.checkpoint and torch.is_grad_enabled()
        for name, st in zip(self.names, self.stages()):
            depth = 3 if name == "mid" else (int(name[-1]) if name.startswith("down")
                                             else 3 - int(name[-1]))
            for j in range(len(st.resnets)):
                if name.startswith("up"):
                    x = torch.cat([x, skips.pop()], dim=2)
                if name == "mid" and j == 1:
                    x = st.resnets[1](x, temb)
                    break
                r = mf = None
                if ref is not None and hasattr(st, "attentions"):
                    r = ref[name][j].repeat_interleave(f, dim=0)
                if (motion is not None and hasattr(st, "attentions")
                        and hasattr(st, "motion_modules")
                        and (fusion == "all" or name == fusion)):
                    mf = motion[name][j]
                args = (st, name, j, x, temb, context_f, r, audio, masks[depth],
                        motion_scale, mf, uncond)
                x = (torch.utils.checkpoint.checkpoint(self._layer, *args, use_reentrant=False)
                     if remat else self._layer(*args))
                if name.startswith("down"):
                    skips.append(x)
            if hasattr(st, "downsamplers"):
                x = st.downsamplers[0](x)
                skips.append(x)
            if hasattr(st, "upsamplers"):
                x = st.upsamplers[0](x)
        x = F.silu(self.conv_norm_out(x, inflated=True))
        return _unfold(self.conv_out(_fold(x)), f)


class VAEResnet(nn.Module):
    def __init__(self, cin, cout, groups):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x) + h


class VAEAttention(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch, eps=1e-6)
        self.to_q = Linear(ch, ch)
        self.to_k = Linear(ch, ch)
        self.to_v = Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch), nn.Identity()])

    def forward(self, x):
        b, c, h, w = x.shape
        n = _tokens(self.group_norm(x))
        out = attention(self.to_q(n), self.to_k(n), self.to_v(n), 1, kind="vae")
        return x + _image(self.to_out[0](out), h, w)


class VAEMid(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(ch, ch, groups) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Down(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _Up(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class VAEStage(nn.Module):
    def __init__(self, cin, ch, n, groups, sampler=None, name=""):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(cin if j == 0 else ch, ch, groups)
                                      for j in range(n)])
        if sampler is not None:
            setattr(self, name, nn.ModuleList([sampler]))

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for name in ("downsamplers", "upsamplers"):
            if hasattr(self, name):
                x = getattr(self, name)[0](x)
        return x


class VAE(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        self.v = v
        ch, g, lpb = v["block_out_channels"], v["norm_num_groups"], v["layers_per_block"]
        enc, dec = nn.Module(), nn.Module()
        enc.conv_in = Conv2d(v["in_channels"], ch[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList([
            VAEStage(ch[i - 1] if i else ch[0], ch[i], lpb, g,
                     _Down(ch[i]) if i < len(ch) - 1 else None, "downsamplers")
            for i in range(len(ch))])
        enc.mid_block = VAEMid(ch[-1], g)
        enc.conv_norm_out = GroupNorm(g, ch[-1], eps=1e-6)
        enc.conv_out = Conv2d(ch[-1], 2 * v["latent_channels"], 3, padding=1)
        r = tuple(reversed(ch))
        dec.conv_in = Conv2d(v["latent_channels"], r[0], 3, padding=1)
        dec.mid_block = VAEMid(r[0], g)
        dec.up_blocks = nn.ModuleList([
            VAEStage(r[i - 1] if i else r[0], r[i], lpb + 1, g,
                     _Up(r[i]) if i < len(r) - 1 else None, "upsamplers")
            for i in range(len(r))])
        dec.conv_norm_out = GroupNorm(g, r[-1], eps=1e-6)
        dec.conv_out = Conv2d(r[-1], v["out_channels"], 3, padding=1)
        self.encoder, self.decoder = enc, dec
        lc = v["latent_channels"]
        self.quant_conv = Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = Conv2d(lc, lc, 1)

    def encode_mean(self, x):
        """(N, 3, H, W) pixels in [-1, 1] -> scaled posterior mean."""
        e = self.encoder
        h = e.conv_in(x)
        for blk in e.down_blocks:
            h = blk(h)
        h = e.conv_out(F.silu(e.conv_norm_out(e.mid_block(h))))
        return self.quant_conv(h)[:, :self.v["latent_channels"]] * self.v["scaling_factor"]

    def decode(self, z):
        """Scaled latents (N, 4, h, w) -> pixels (N, 3, 8h, 8w)."""
        d = self.decoder
        h = d.mid_block(d.conv_in(self.post_quant_conv(z / self.v["scaling_factor"])))
        for blk in d.up_blocks:
            h = blk(h)
        return d.conv_out(F.silu(d.conv_norm_out(h)))


class FaceLocator(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        ch = c["block_out_channels"]
        self.conv_in = Conv2d(c["conditioning_channels"], ch[0], 3, padding=1)
        blocks = []
        for i in range(len(ch) - 1):
            blocks += [Conv2d(ch[i], ch[i], 3, padding=1),
                       Conv2d(ch[i], ch[i + 1], 3, stride=2, padding=1)]
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = Conv2d(ch[-1], c["conditioning_embedding_channels"], 3, padding=1)

    def forward(self, x):
        x = F.silu(self.conv_in(x))
        for conv in self.blocks:
            x = F.silu(conv(x))
        return self.conv_out(x)


class ImageProj(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.proj = Linear(c["clip_embeddings_dim"],
                           c["clip_extra_context_tokens"] * c["cross_attention_dim"])
        self.norm = LayerNorm(c["cross_attention_dim"])

    def forward(self, e):
        c = self.c
        return self.norm(self.proj(e).reshape(-1, c["clip_extra_context_tokens"],
                                              c["cross_attention_dim"]))


class AudioProj(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.proj1 = Linear(c["seq_len"] * c["blocks"] * c["channels"], c["intermediate_dim"])
        self.proj2 = Linear(c["intermediate_dim"], c["intermediate_dim"])
        self.proj3 = Linear(c["intermediate_dim"], c["context_tokens"] * c["output_dim"])
        self.norm = LayerNorm(c["output_dim"])

    def forward(self, a):
        """(B, F, window, blocks, channels) -> (B, F, tokens, dim)."""
        c = self.c
        b, f = a.shape[:2]
        x = F.relu(self.proj2(F.relu(self.proj1(a.reshape(b * f, -1)))))
        x = self.norm(self.proj3(x).reshape(b * f, c["context_tokens"], c["output_dim"]))
        return x.reshape(b, f, c["context_tokens"], c["output_dim"])


def build(cfg: dict, device="meta") -> Dict[str, nn.Module]:
    """The six modules of `cfg` (a configuration file's dict), keyed as the
    measured program keys them, with uninitialised parameters on `device`."""
    with torch.device(device):
        ref_u = dict(cfg["unet"], use_motion_module=False, use_audio_module=False)
        mods = dict(
            vae=VAE(cfg["vae"]),
            reference_net=ReferenceNet(ref_u),
            denoising_net=DenoisingUNet(cfg["unet"]),
            face_locator=FaceLocator(cfg["face_locator"]),
            image_proj=ImageProj(cfg["image_proj"]),
            audio_proj=AudioProj(cfg["audio_proj"]),
        )
    return mods
