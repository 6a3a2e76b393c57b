"""Optimizers as pure functions of flat leaf dicts: AdamW and Adafactor --
the port of ``repro/optim/optimizers.py``.

A "tree" here is a dict {path: tensor} in the reference's
``jax.tree.flatten`` order (:func:`repro_torch.models.convert.leaf_groups`
gives a model's paths); a leaf is the tensor the reference's optimizer
sees, so a pattern slot's G layers arrive stacked as (G, ...) and
Adafactor factors, and clips the update's RMS, over the stack as the
reference does.

Mixed-precision contract, as in the reference: parameters may be bf16;
the optimizer keeps float32 master weights (AdamW) or float32 factored
statistics (Adafactor) and returns the updated master cast to each
parameter's dtype (round to nearest).  State tensors live on the
parameters' device.

On a mesh the leaves are the rank's blocks (``shards``, a
:class:`~repro_torch.models.sharding.LeafShards`): AdamW is elementwise;
the global norm sums each leaf's squares over the groups that shard it
(a replicated leaf once); Adafactor's row and column statistics and its
update RMS sum over the groups that shard the dimensions they average.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["OptConfig", "global_norm", "clip_by_global_norm", "init_opt",
           "opt_update"]

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"              # adamw | adafactor
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def global_norm(tree: dict, reduce_sq=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's sum of
    squares, in float32.  ``reduce_sq`` ({path: sum of squares} ->
    the same, summed over the ranks that shard those leaves) completes a
    sharded leaf's sum before the total."""
    sq = {k: torch.sum(torch.square(x.to(F32))) for k, x in tree.items()}
    if reduce_sq is not None:
        sq = reduce_sq(sq)
    total = 0
    for v in sq.values():
        total = total + v
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm, reduce_sq=None):
    """(grads in float32 scaled by min(1, max_norm / norm), norm)."""
    g = global_norm(grads, reduce_sq)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    return {k: x.to(F32) * scale for k, x in grads.items()}, g


def _master(params: dict) -> dict:
    """float32 copies of the parameters, never aliasing one (a float32
    parameter is updated in place while its master lives on)."""
    return {k: p.detach().to(F32, copy=True) for k, p in params.items()}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _adamw_init(params: dict) -> dict:
    dev = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                   for k, p in params.items()},
            "nu": {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                   for k, p in params.items()},
            "master": _master(params)}


def _adamw_update(grads32, state, params, lr, cfg: OptConfig):
    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step.to(F32)
    c2 = 1.0 - b2 ** step.to(F32)
    new_p, mu2, nu2, ma2 = {}, {}, {}, {}
    for k, p in params.items():
        g, master = grads32[k], state["master"][k]
        mu = b1 * state["mu"][k] + (1 - b1) * g
        nu = b2 * state["nu"][k] + (1 - b2) * g * g
        m_hat = mu / c1
        v_hat = nu / c2
        new = master - lr * (m_hat / (torch.sqrt(v_hat) + cfg.eps)
                             + cfg.weight_decay * master)
        new_p[k], mu2[k], nu2[k], ma2[k] = new.to(p.dtype), mu, nu, new
    return new_p, {"step": step, "mu": mu2, "nu": nu2, "master": ma2}


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), factored second moments
# ---------------------------------------------------------------------------

def _adafactor_init(params: dict) -> dict:
    def stats(p):
        kw = dict(dtype=F32, device=p.device)
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], **kw),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
        return {"v": torch.zeros(p.shape, **kw)}
    dev = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "stats": {k: stats(p) for k, p in params.items()},
            "master": _master(params)}


def _update_rms(k, u, eps, shards=None):
    """The update leaf ``k``'s RMS, sqrt(mean(u^2) + eps), over the whole
    leaf: for a leaf that ``shards`` splits, the sum of squares and the
    element count are summed over its ranks first (in float64)."""
    if shards is None or shards.leaf_group(k) is None:
        return torch.sqrt(torch.mean(u * u) + eps)
    part = torch.stack([torch.sum(u * u).double(),
                        torch.tensor(u.numel(), dtype=torch.float64,
                                     device=u.device)])
    ss, n = shards.reduce_sq({k: part})[k]
    return torch.sqrt((ss / n).to(F32) + eps)


def _mean(shards, k, x, dim, leaf_dim, keepdim=False):
    """torch.mean over ``dim``; over the whole leaf dimension
    ``leaf_dim`` when ``shards`` splits it."""
    if shards is None:
        out = torch.mean(x, dim)
    else:
        out = shards.mean(k, x, dim, leaf_dim)
    return out.unsqueeze(dim) if keepdim else out


def _adafactor_update(grads32, state, params, lr, cfg: OptConfig,
                      shards=None):
    step = state["step"] + 1
    beta2 = 1.0 - step.to(F32) ** -0.8
    eps = 1e-30
    new_p, st2, ma2 = {}, {}, {}
    for k, p in params.items():
        g, st, master = grads32[k], state["stats"][k], state["master"][k]
        if p.ndim >= 2:
            vr = beta2 * st["vr"] + (1 - beta2) * _mean(
                shards, k, g * g + eps, -1, -1)
            vc = beta2 * st["vc"] + (1 - beta2) * _mean(
                shards, k, g * g + eps, -2, -2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(_mean(shards, k, vr, -1, -2,
                                         keepdim=True)[..., None],
                                   min=eps))
            u = g * torch.rsqrt(denom + eps)
            st2[k] = {"vr": vr, "vc": vc}
        else:
            v = beta2 * st["v"] + (1 - beta2) * (g * g + eps)
            u = g * torch.rsqrt(v + eps)
            st2[k] = {"v": v}
        # update clipping (RMS <= 1), one RMS over the whole (stacked) leaf
        rms = _update_rms(k, u, eps, shards)
        u = u / torch.clamp(rms, min=1.0)
        new = master - lr * (u + cfg.weight_decay * master)
        new_p[k], ma2[k] = new.to(p.dtype), new
    return new_p, {"step": step, "stats": st2, "master": ma2}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def init_opt(cfg: OptConfig, params: dict) -> dict:
    """The optimizer state of ``params`` ({path: tensor}, stacked leaves
    as the reference stacks them)."""
    if cfg.name == "adamw":
        return _adamw_init(params)
    if cfg.name == "adafactor":
        return _adafactor_init(params)
    raise ValueError(cfg.name)


def opt_update(cfg: OptConfig, grads: dict, state: dict, params: dict, lr,
               shards=None):
    """grads may be any float dtype; clipping and the update in float32.
    Returns (new params {path: tensor in each parameter's dtype}, new
    state, grad norm).  ``shards``: where each leaf lives on the mesh
    (:class:`~repro_torch.models.sharding.LeafShards`), for the global
    norm and Adafactor's statistics over sharded leaves."""
    grads32, gnorm = clip_by_global_norm(
        grads, cfg.clip_norm, None if shards is None else shards.reduce_sq)
    if cfg.name == "adamw":
        params2, state2 = _adamw_update(grads32, state, params, lr, cfg)
    elif cfg.name == "adafactor":
        params2, state2 = _adafactor_update(grads32, state, params, lr, cfg,
                                            shards)
    else:
        raise ValueError(cfg.name)
    return params2, state2, gnorm
