"""AdamW with global-norm clipping, as the JAX package computes it.

Port of ``repro/train/optimizer.py``. Not ``torch.optim.AdamW``: that one
adds ``eps`` after the bias correction of ``v`` only and decays the
weights before the update, another function. Here the step is the JAX
package's, op for op in float32: the learning rate, both bias
corrections and the clip scale are float32 tensors on the parameters'
device (Python float64 arithmetic would change their last bits).

Trees are flat ``{name: tensor}`` dicts whose order is the JAX package's
leaf order (:func:`repro_torch.models.convert.named_leaves`), the order
:func:`global_norm` sums in. A leaf whose gradient is ``None`` (the
parameter took no part in the loss, or only through a non-differentiable
op such as the bucket shuffle's byte framing) takes a zero gradient, as
JAX differentiates it: its moments and its weight decay still step.
Parameters, moments and the optional float32 ``master`` copy are updated
in place. :func:`zero1_specs` derives the moments' sharding specs (ZeRO-1,
over the data axis) from the parameters'; the sharded step
(:func:`repro_torch.train.trainer.jit_train_step`) updates a process's
moment shards and the matching slices of its parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.comm import Spec


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio * lr``; a float32
    tensor on ``step``'s device."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decayed)


def init_opt_state(params: Mapping[str, torch.Tensor],
                   master: bool = False) -> Dict:
    """AdamW moments (+ optional float32 master weights for bfloat16
    parameters), float32 zeros by name, and the int32 step."""
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    device = next(iter(params.values())).device
    out = {"m": zeros,
           "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
           "step": torch.zeros((), dtype=torch.int32, device=device)}
    if master:
        out["master"] = {n: p.detach().float().clone()
                         for n, p in params.items()}
    return out


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of the leaves' float32 sums of squares, added leaf
    by leaf in the given order (``None`` counts as zeros)."""
    total = 0
    for x in tensors:
        if x is not None:
            total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a float32 tensor beside ``like``: a Python scalar on the
    left of ``/`` would be computed as ``v * reciprocal(x)``, rounding
    twice."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, Optional[torch.Tensor]],
                 opt_state: Dict, gnorm: Optional[torch.Tensor] = None):
    """One AdamW step with global-norm clipping, in place. Returns
    ``(params, opt_state, metrics)`` with ``metrics`` the float32
    ``grad_norm`` (before clipping) and ``lr`` tensors. ``gnorm``: the
    norm of the whole gradient where ``grads`` hold shards of it (the
    sharded step's, :func:`repro_torch.train.trainer.jit_train_step`);
    by default :func:`global_norm` of ``grads``."""
    step = opt_state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads.get(n) for n in params)
    scale = torch.clamp(_scalar(cfg.grad_clip, gnorm) / (gnorm + 1e-9),
                        max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    master = opt_state.get("master")

    for name, p in params.items():
        g = grads.get(name)
        m, v = opt_state["m"][name], opt_state["v"][name]
        g = (g.float() if g is not None else torch.zeros_like(m)) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        base = master[name] if master is not None else p.float()
        new = base - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                           + cfg.weight_decay * base)
        p.copy_(new)
        if master is not None:
            base.copy_(new)
    opt_state["step"].copy_(step)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def zero1_specs(param_specs: Mapping[str, Spec],
                shapes: Mapping[str, Sequence[int]],
                data_axes: Tuple[str, ...] = ("data",),
                mesh_shape: Optional[Mapping[str, int]] = None
                ) -> Dict[str, Spec]:
    """ZeRO-1: each moment's spec from its parameter's, the largest
    replicated dimension that the data axes divide sharded over them (the
    last such dimension on a tie), as the JAX package derives them. A
    spec that changes is padded with ``None`` to the parameter's rank;
    one that does not is returned as given. ``shapes``: each parameter's
    shape, by the same names."""
    dsize = 1
    for a in data_axes:
        dsize *= (mesh_shape or {}).get(a, 1)

    def one(spec: Spec, shape) -> Spec:
        shape = tuple(shape)
        if dsize <= 1 or not shape:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        cands = [(shape[i], i) for i, e in enumerate(entries)
                 if e is None and shape[i] % dsize == 0]
        if not cands:
            return spec
        _, idx = max(cands)
        entries[idx] = tuple(data_axes) if len(data_axes) > 1 \
            else data_axes[0]
        return tuple(entries)

    return {name: one(spec, shapes[name])
            for name, spec in param_specs.items()}
