"""AdamW and its schedules over the nested parameter dict (the JAX
package's ``repro.optim.adamw``, same math): moments in f32, updates
computed in f32 and cast back to each parameter's dtype. Functions of
tensors, no ``torch.optim``: the state is a tree shaped like the
parameters, so it checkpoints and crosses the bridge as they do."""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Tuple, Union

import torch

from repro_torch.bridge import flatten, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32, steps taken
    mu: Dict               # first moments, f32, shaped like the params
    nu: Dict               # second moments, f32


def adamw_init(params: Dict) -> AdamWState:
    flat = flatten(params)
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in flat.items()}
    dev = next(iter(flat.values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=unflatten(zeros),
                      nu=unflatten({k: z.clone() for k, z in zeros.items()}))


Schedule = Callable[[torch.Tensor], torch.Tensor]


@torch.no_grad()
def adamw_update(grads: Dict, state: AdamWState, params: Dict, *,
                 lr: Union[float, Schedule], b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Dict, AdamWState]:
    """One AdamW step with bias correction and decoupled weight decay.
    Returns (new params, new state); the inputs are left as they were."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    stepf = step.float()
    c1 = 1 - b1 ** stepf
    c2 = 1 - b2 ** stepf
    fp, fg = flatten(params), flatten(grads)
    fm, fv = flatten(state.mu), flatten(state.nu)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in fp.items():
        g = fg[k].float()
        m = b1 * fm[k] + (1 - b1) * g
        v = b2 * fv[k] + (1 - b2) * g * g
        pf = p.float()
        new_p[k] = (pf - lr_t * ((m / c1) / (torch.sqrt(v / c2) + eps)
                                 + weight_decay * pf)).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return unflatten(new_p), AdamWState(step=step, mu=unflatten(new_m),
                                        nu=unflatten(new_v))


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Schedule:
    """Linear warm-up over ``warmup`` steps, then a cosine decay to 0 at
    ``total``; a function of the (integer tensor) step."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        frac = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return sched


@torch.no_grad()
def clip_by_global_norm(grads: Dict, max_norm: float
                        ) -> Tuple[Dict, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / global norm), in f32 as
    the JAX package's promotion gives. Returns (scaled grads, the global
    norm before scaling)."""
    flat = flatten(grads)
    gn = torch.sqrt(sum((g.float() ** 2).sum() for g in flat.values()))
    scale = torch.clamp(max_norm / gn.clamp_min(1e-9), max=1.0)
    return unflatten({k: g.float() * scale for k, g in flat.items()}), gn
