"""Train state and optimizer over the trainable parameter subset
(counterpart of hallo_tpu/train/state.py).

The JAX package freezes by labels (`optax.multi_transform` with
`set_to_zero` on the frozen leaves) and steps
`optax.chain(clip_by_global_norm, adamw)`, wrapped in `optax.MultiSteps`
for gradient accumulation. The port keeps the reference's `requires_grad`
semantics instead: only the trainable parameters get gradients, and `AdamW`
steps fp32 master copies of those alone with optax's arithmetic:

- the clip scales by max_norm / norm (no epsilon) when norm >= max_norm;
- Adam's moments and bias corrections, eps outside the square root;
- decoupled weight decay on the trainable leaves;
- the learning rate of `optax.linear_schedule(0, lr, warmup)` at the
  update's count, so the first update of a warm-up moves no weight (but
  does update the moments);
- with k > 1 accumulation steps, the running mean of k micro-batch
  gradients is applied every k-th call (`MultiSteps`' `use_grad_mean`).

The masters, moments and accumulator are updated in place. With
`use_8bit_adam` the moments are stored as int8 blocks (`train/adam8bit.py`,
`make_optimizer`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    # reference solver knobs (configs/train/stage2.yaml:23-37)
    lr_warmup_steps: int = 0
    gradient_accumulation_steps: int = 1
    # bnb.optim.AdamW8bit's counterpart (train_stage2.py:613-622): int8
    # block-quantised moments (train/adam8bit.py)
    use_8bit_adam: bool = False


def stage1_trainable(top_key: str, name: str) -> bool:
    """Stage 1 trains the ReferenceNet, the denoiser (2D), the face locator
    and the image projection (train_stage1.py:372-394); the VAE and the
    audio projection stay frozen."""
    return top_key in ("reference_net", "denoising_net", "face_locator", "image_proj")


def stage2_trainable(top_key: str, name: str) -> bool:
    """Stage 2 trains the motion and audio modules inside the denoiser, plus
    the audio projection (stage2.yaml:84-86, train_stage2.py:553-560). `name`
    is the parameter's name within module `top_key`; the port's names carry
    the reference keys, so JAX's substring rule selects the same leaves."""
    if top_key == "audio_proj":
        return True
    if top_key != "denoising_net":
        return False
    return any("motion_modules" in p or "audio_modules" in p for p in name.split("."))


def unfreeze(modules: Mapping[str, torch.nn.Module],
             trainable_fn: Callable[[str, str], bool]) -> Dict[str, torch.nn.Parameter]:
    """Set requires_grad on the parameters `trainable_fn` selects (the others
    stay frozen) and return them keyed "module.name"."""
    out = {}
    for top, module in modules.items():
        for name, p in module.named_parameters():
            train = trainable_fn(top, name)
            p.requires_grad_(train)
            if train:
                out[f"{top}.{name}"] = p
    return out


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element, in fp32
    (`optax.global_norm`): each tensor's norm, then the norm of those."""
    norms = torch._foreach_norm(list(tensors), 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """`optax.MultiSteps(chain(clip_by_global_norm, adamw))` over the
    trainable leaves; see the module docstring."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg

    def learning_rate(self, count: int) -> float:
        """optax.linear_schedule(0, lr, warmup) at `count` (lr without warm-up)."""
        lr, warmup = self.cfg.learning_rate, self.cfg.lr_warmup_steps
        if warmup <= 0:
            return lr
        frac = 1.0 - min(max(count, 0), warmup) / warmup
        return (0.0 - lr) * frac + lr

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        state: Dict[str, Any] = dict(
            count=0,
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )
        if self.cfg.gradient_accumulation_steps > 1:
            state.update(mini_step=0, gradient_step=0,
                         acc={k: torch.zeros_like(p) for k, p in params.items()})
        return state

    def update(self, grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
               params: Dict[str, torch.Tensor]) -> None:
        """Step the fp32 `params` in place with `grads` (any float dtype,
        upcast per tensor). Each operation runs over every tensor at once
        (`torch._foreach_*`)."""
        cfg = self.cfg
        k = cfg.gradient_accumulation_steps
        names = list(params)
        gs = [grads[name].float() for name in names]
        if k > 1:
            n = state["mini_step"]
            accs = [state["acc"][name] for name in names]
            delta = torch._foreach_sub(gs, accs)
            torch._foreach_div_(delta, n + 1)
            torch._foreach_add_(accs, delta)
            if n < k - 1:
                state["mini_step"] = n + 1
                return
            gs = accs
        norm = float(global_norm(gs))
        if not norm < cfg.max_grad_norm:
            gs = torch._foreach_div(gs, norm)
            torch._foreach_mul_(gs, cfg.max_grad_norm)
        count = state["count"]
        self.adam(dict(zip(names, gs)), state, params, count + 1, self.learning_rate(count))
        state["count"] = count + 1
        if k > 1:
            for acc in state["acc"].values():
                acc.zero_()
            state["mini_step"] = 0
            state["gradient_step"] += 1

    def adam(self, gs: Mapping[str, torch.Tensor], state: Dict[str, Any],
             params: Dict[str, torch.Tensor], count: int, lr: float) -> None:
        """Adam's moments, bias corrections at `count`, weight decay and the
        step of `lr`, over the fp32 gradients `gs` (one per name of
        `params`)."""
        cfg = self.cfg
        names = list(gs)
        c1 = 1.0 - cfg.beta1 ** count
        c2 = 1.0 - cfg.beta2 ** count
        g = [gs[name] for name in names]
        ps = [params[name] for name in names]
        mus = [state["mu"][name] for name in names]
        nus = [state["nu"][name] for name in names]
        torch._foreach_mul_(mus, cfg.beta1)
        torch._foreach_add_(mus, g, alpha=1.0 - cfg.beta1)
        torch._foreach_mul_(nus, cfg.beta2)
        torch._foreach_addcmul_(nus, g, g, value=1.0 - cfg.beta2)
        den = torch._foreach_div(nus, c2)  # sqrt(nu / c2) + eps
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        u = torch._foreach_div(mus, c1)
        torch._foreach_div_(u, den)
        del den
        torch._foreach_add_(u, ps, alpha=cfg.weight_decay)
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(ps, u)


def make_optimizer(cfg: OptimizerConfig) -> AdamW:
    """`AdamW`, or with `cfg.use_8bit_adam` its int8-moment form
    (`adam8bit.AdamW8bit`; JAX's `make_optimizer`)."""
    if cfg.use_8bit_adam:
        from hallo_tpu_torch.train.adam8bit import AdamW8bit

        return AdamW8bit(cfg)
    return AdamW(cfg)


@dataclasses.dataclass
class TrainState:
    """step: the number of train steps taken (skipped ones included, as in
    JAX); params: fp32 master copies of the trainable parameters, keyed
    "module.name"; opt_state: `AdamW`'s state."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]

    @classmethod
    def create(cls, trainable: Mapping[str, torch.nn.Parameter], opt: AdamW) -> "TrainState":
        params = {k: p.detach().float().clone() for k, p in trainable.items()}
        return cls(step=0, params=params, opt_state=opt.init(params))

    def write_to(self, trainable: Mapping[str, torch.nn.Parameter]) -> None:
        """Copy the masters into the model's parameters (in their dtype)."""
        with torch.no_grad():
            torch._foreach_copy_(list(trainable.values()),
                                 [self.params[name] for name in trainable])

    def state_dict(self) -> Dict[str, Any]:
        return dict(step=self.step, params=self.params, opt_state=self.opt_state)

    @classmethod
    def from_state_dict(cls, sd: Mapping[str, Any]) -> "TrainState":
        return cls(step=int(sd["step"]), params=dict(sd["params"]),
                   opt_state=dict(sd["opt_state"]))
