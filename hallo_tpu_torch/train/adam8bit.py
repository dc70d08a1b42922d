"""AdamW with int8 block-quantised moments (counterpart of
hallo_tpu/train/adam8bit.py; bitsandbytes' AdamW8bit, the reference's
stage-2 optimizer, train_stage2.py:613-622).

The JAX package's arithmetic, block by block of 256 elements of a leaf's
flattened tensor:
- mu (signed): linear absmax codes, scale = absmax / 127 (1 for an all-zero
  block), q = round(x / scale) in [-127, 127];
- nu (non-negative, many decades within a block): codes in log space over
  a fixed span of 20.3 nats below the block's log max `hi`, q in
  [-128, 127]; a code of -128 (the span's floor) dequantises to exactly 0;
- a leaf of fewer than 256 elements keeps fp32 moments;
- the update dequantises, steps the moments in fp32, takes Adam's direction
  from the fresh moments (bias-corrected, eps outside the square root),
  requantises, then adds the decoupled weight decay and the learning rate
  (optax's chain(scale_by_adam_8bit, add_decayed_weights,
  scale_by_learning_rate)).

XLA flushes subnormal floats to zero on the CPU and the TPU, so JAX's
`log(max(x, 1e-38))` is log(0) = -inf below the smallest normal float; an
all-zero block then has hi = -inf and NaN codes, which XLA converts to 0
(dequantised: 0). The port reproduces that explicitly (`_log_floor`,
`_codes`), so that its codes are JAX's on every device.

The port's layout: the quantised leaves' codes live in one flat int8 store
per moment, each leaf starting on a block boundary (so its blocks are
JAX's), with one fp32 scale per block. The update walks that store in
segments of at most `SEGMENT_ELEMS` elements (whole blocks; JAX's
`CHUNK_ELEMS` chunking bounds its temporaries the same way), about 30
launches a segment, instead of a dozen per leaf: ~1.7 G stage-1 parameters
take about 26 segments.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch

from hallo_tpu_torch.train.state import AdamW

BLOCK = 256
# nu's log-space span: 255 steps over 20.3 nats (about 8.8 decades below
# the block max); one step is 0.08 nats, about 4% relative error
_LOG_SPAN = 20.3
# the smallest normal fp32: below it XLA's flushed max(x, 1e-38) is 0
_FLT_MIN = torch.finfo(torch.float32).tiny
SEGMENT_ELEMS = 2**26


def _rows(x: torch.Tensor, block: int, fill: float = 0.0) -> torch.Tensor:
    """The flattened tensor padded with `fill` to whole blocks: (rows, block)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_full((pad,), fill)])
    return flat.view(-1, block)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _unrows(r: torch.Tensor, shape) -> torch.Tensor:
    return r.reshape(-1)[:_numel(shape)].reshape(shape)


def _linear_codes(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, block) fp32 -> int8 absmax codes and the per-row scales."""
    absmax = m.abs().amax(dim=1)
    scales = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(m / scales[:, None]), -127, 127).to(torch.int8)
    return q, scales


def _log_floor(v: torch.Tensor) -> torch.Tensor:
    """log(max(v, 1e-38)) as XLA computes it: -inf below the smallest normal."""
    return torch.log(torch.where(v < _FLT_MIN, torch.zeros_like(v), v))


def _codes(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """clip(x) to int8, NaN to 0 (XLA's float-to-int conversion)."""
    return torch.nan_to_num(torch.clamp(x, lo, hi), nan=0.0).to(torch.int8)


def _log_codes(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, block) non-negative fp32 -> int8 log-space codes and the
    per-row log max."""
    logv = _log_floor(v)
    hi = logv.amax(dim=1)
    rel = (logv - (hi[:, None] - _LOG_SPAN)) / _LOG_SPAN
    return _codes(torch.round(rel * 255.0) - 128.0, -128, 127), hi


def _linear_values(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return q.float() * scales[:, None]


def _log_values(q: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    qf = q.float()
    logx = (qf + 128.0) / 255.0 * _LOG_SPAN + (hi[:, None] - _LOG_SPAN)
    return torch.where(qf <= -127.5, torch.zeros_like(qf), torch.exp(logx))


class Quantized(NamedTuple):
    """One leaf's moment: int8 codes of the leaf's shape and one fp32 scale
    (mu) or log max (nu) per block; or, for a leaf smaller than a block,
    the fp32 moment itself and an empty scale."""

    q: torch.Tensor
    scales: torch.Tensor


def quantize(x: torch.Tensor, block: int = BLOCK) -> Quantized:
    """JAX's `_quantize`: linear absmax codes (mu)."""
    if x.numel() < block or not x.is_floating_point():
        return Quantized(x.float(), torch.zeros((), device=x.device))
    q, scales = _linear_codes(_rows(x.float(), block))
    return Quantized(_unrows(q, x.shape), scales)


def quantize_log(x: torch.Tensor, block: int = BLOCK) -> Quantized:
    """JAX's `_quantize_log`: log-space codes (nu)."""
    if x.numel() < block or not x.is_floating_point():
        return Quantized(x.float(), torch.zeros((), device=x.device))
    q, hi = _log_codes(_rows(x.float(), block))
    return Quantized(_unrows(q, x.shape), hi)


def dequantize(qs: Quantized, block: int = BLOCK) -> torch.Tensor:
    if qs.q.dtype != torch.int8:
        return qs.q
    return _unrows(_linear_values(_rows(qs.q, block), qs.scales), qs.q.shape)


def dequantize_log(qs: Quantized, block: int = BLOCK) -> torch.Tensor:
    if qs.q.dtype != torch.int8:
        return qs.q
    return _unrows(_log_values(_rows(qs.q, block, fill=-128), qs.scales), qs.q.shape)


class _Piece(NamedTuple):
    """Elements [start, stop) of leaf `name`, at rows [row, ...) of a
    segment; `pad` zeros fill its last block."""

    name: str
    start: int
    stop: int
    pad: int


class AdamW8bit(AdamW):
    """`AdamW` (clip, warm-up, accumulation) with int8 moments for every
    leaf of at least `BLOCK` elements (JAX's `adamw_8bit`). The state holds
    `mu`/`nu` fp32 for the small leaves and, under "q8", the flat stores:
    `mu_q`, `nu_q` int8 (rows, BLOCK), `mu_scale`, `nu_hi` fp32 (rows,), and
    `rows`, each quantised leaf's first row."""

    needs_whole_leaves = True  # blocks of the whole leaf

    def init(self, params: Mapping[str, torch.Tensor],
             sizes: Optional[Mapping[str, int]] = None) -> Dict[str, Any]:
        """The state of `params`; `sizes`: the element count of the leaf each
        tensor is a piece of (a ZeRO shard's, whose pieces start on block
        boundaries of their leaves): a piece of a leaf of at least `BLOCK`
        elements is quantised, whatever its own size."""
        quantised = {k for k, p in params.items()
                     if (sizes[k] if sizes is not None else p.numel()) >= BLOCK}
        state = super().init({k: p for k, p in params.items() if k not in quantised})
        if self.cfg.gradient_accumulation_steps > 1:
            state["acc"] = {k: torch.zeros_like(p) for k, p in params.items()}
        rows, n = {}, 0
        for k, p in params.items():
            if k in quantised:
                rows[k] = n
                n += -(-p.numel() // BLOCK)
        dev = next(iter(params.values())).device if params else torch.device("cpu")
        # zero moments: mu codes 0 with scale 1; nu codes 0 with log max
        # -inf (`_log_codes` of an all-zero block), which dequantise to 0
        state["q8"] = dict(
            rows=rows,
            shapes={k: tuple(params[k].shape) for k in rows},
            mu_q=torch.zeros((n, BLOCK), dtype=torch.int8, device=dev),
            mu_scale=torch.ones(n, device=dev),
            nu_q=torch.zeros((n, BLOCK), dtype=torch.int8, device=dev),
            nu_hi=torch.full((n,), float("-inf"), device=dev),
        )
        return state

    @staticmethod
    def leaf_moments(state: Dict[str, Any], name: str) -> Tuple[Quantized, Quantized]:
        """(mu, nu) of one leaf in JAX's per-leaf form (views of the store)."""
        if name in state["mu"]:
            return (Quantized(state["mu"][name], torch.zeros(())),
                    Quantized(state["nu"][name], torch.zeros(())))
        q8 = state["q8"]
        shape = q8["shapes"][name]
        n = _numel(shape)
        r0 = q8["rows"][name]
        r1 = r0 + -(-n // BLOCK)
        return (Quantized(q8["mu_q"][r0:r1].reshape(-1)[:n].view(shape), q8["mu_scale"][r0:r1]),
                Quantized(q8["nu_q"][r0:r1].reshape(-1)[:n].view(shape), q8["nu_hi"][r0:r1]))

    @staticmethod
    def _segments(q8: Mapping[str, Any]) -> List[Tuple[int, int, List[_Piece]]]:
        """Row ranges of at most SEGMENT_ELEMS elements (a leaf larger than
        that is split between rows), each with the leaf pieces it holds."""
        per = max(1, SEGMENT_ELEMS // BLOCK)
        segments, pieces, seg_start, seg_rows = [], [], None, 0
        for name, r0 in sorted(q8["rows"].items(), key=lambda kv: kv[1]):
            n = _numel(q8["shapes"][name])
            nrows = -(-n // BLOCK)
            done = 0
            while done < nrows:
                if seg_start is None:
                    seg_start, seg_rows, pieces = r0 + done, 0, []
                take = min(nrows - done, per - seg_rows)
                start, stop = done * BLOCK, min(n, (done + take) * BLOCK)
                pieces.append(_Piece(name, start, stop, take * BLOCK - (stop - start)))
                done += take
                seg_rows += take
                if seg_rows == per:
                    segments.append((seg_start, seg_start + seg_rows, pieces))
                    seg_start = None
        if seg_start is not None:
            segments.append((seg_start, seg_start + seg_rows, pieces))
        return segments

    def adam(self, gs: Mapping[str, torch.Tensor], state: Dict[str, Any],
             params: Dict[str, torch.Tensor], count: int, lr: float) -> None:
        cfg = self.cfg
        q8 = state["q8"]
        small = {k: g for k, g in gs.items() if k in state["mu"]}
        if small:
            super().adam(small, state, params, count, lr)
        # JAX's bias corrections, in fp32 from the fp32 count
        count_f = torch.tensor(float(count))
        bc1 = float(1 - torch.tensor(cfg.beta1) ** count_f)
        bc2 = float(1 - torch.tensor(cfg.beta2) ** count_f)
        b1, b2 = cfg.beta1, cfg.beta2
        for r0, r1, pieces in self._segments(q8):
            parts = []
            for p in pieces:
                parts.append(gs[p.name].reshape(-1)[p.start:p.stop].float())
                if p.pad:
                    parts.append(parts[-1].new_zeros(p.pad))
            g = (torch.cat(parts) if len(parts) > 1 else parts[0]).view(-1, BLOCK)
            m = _linear_values(q8["mu_q"][r0:r1], q8["mu_scale"][r0:r1])
            m = b1 * m + (1 - b1) * g
            v = _log_values(q8["nu_q"][r0:r1], q8["nu_hi"][r0:r1])
            v = b2 * v + (1 - b2) * g ** 2
            del g
            upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            q8["mu_q"][r0:r1], q8["mu_scale"][r0:r1] = _linear_codes(m)
            del m
            q8["nu_q"][r0:r1], q8["nu_hi"][r0:r1] = _log_codes(v)
            del v
            flat = upd.view(-1)
            us, ps, at = [], [], 0
            for p in pieces:
                us.append(flat[at:at + p.stop - p.start])
                ps.append(params[p.name].view(-1)[p.start:p.stop])
                at += p.stop - p.start + p.pad
            torch._foreach_add_(us, ps, alpha=cfg.weight_decay)
            torch._foreach_mul_(us, -lr)
            torch._foreach_add_(ps, us)


# ZeRO: the flat stores of a shard's pieces and of the whole leaves, in
# whole blocks (a piece starts on a block boundary of its leaf, so its
# blocks are the leaf's blocks).

_STORES = (("mu_q", 0), ("mu_scale", 1.0), ("nu_q", 0), ("nu_hi", float("-inf")))


def gather_q8(shard_q8: Mapping[str, Any], plan, pieces, gather: Callable,
              full_q8: Dict[str, Any]) -> None:
    """Fill `full_q8` (the unsharded layout, `AdamW8bit.init` of the whole
    leaves) from every rank's `shard_q8` (its pieces' stores, keyed by piece
    key): each rank lays its pieces' rows out at their plan rows, `gather`
    (an all_gather over the shards, dim 0) concatenates the shards."""
    for store, fill in _STORES:
        src = shard_q8[store]
        local = src.new_full((plan.shard_rows,) + tuple(src.shape[1:]), fill)
        for p in pieces:
            if p.key in shard_q8["rows"]:
                r0, n = shard_q8["rows"][p.key], -(-(p.stop - p.start) // BLOCK)
                local[p.offset // BLOCK:p.offset // BLOCK + n] = src[r0:r0 + n]
        full = gather(local)
        for i, name in enumerate(plan.names):
            if name in full_q8["rows"]:
                r0, n = full_q8["rows"][name], -(-_numel(plan.shapes[i]) // BLOCK)
                full_q8[store][r0:r0 + n] = full[plan.first_rows[i]:plan.first_rows[i] + n]


def shard_q8(full_q8: Mapping[str, Any], pieces, shard_q8: Dict[str, Any]) -> None:
    """Fill `shard_q8` (a shard's stores, `AdamW8bit.init` of its pieces)
    from the unsharded `full_q8`: each piece's rows of its leaf's rows."""
    for p in pieces:
        if p.key in shard_q8["rows"]:
            src = full_q8["rows"][p.name] + p.start // BLOCK
            dst, n = shard_q8["rows"][p.key], -(-(p.stop - p.start) // BLOCK)
            for store, _ in _STORES:
                shard_q8[store][dst:dst + n] = full_q8[store][src:src + n]
