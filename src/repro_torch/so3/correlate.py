"""Rotational correlation on SO(3) via batched inverse FFTs: the port of
``repro.so3.correlate``.

The correlation theorem (PAPER.md Sec. 1; Kovacs & Wriggers 2002): for
f, g bandlimited on S^2 with coefficient vectors f_l, g_l,

    C(R) = sum_l <f_l, D^l(R) g_l> = sum_{l,m,m'} conj(f[l,m]) D^l_{mm'}(R)
           g[l,m']

so ALL (2B)^3 grid correlations are ONE inverse SO(3) FFT of the
outer-product coefficient array T[l, m, m'] = conj(f[l, m]) g[l, m'].
The engine evaluates batches of such T through a
:class:`repro_torch.plan.Transform`'s lane-packed ``inverse_batch``
executor: V correlation problems ride one ``idwt_fused`` launch.

Request shapes served:

  * :meth:`CorrelationEngine.match`       -- one (f, g) pair
  * :meth:`CorrelationEngine.match_bank`  -- one query vs a template bank
  * :meth:`CorrelationEngine.match_batch` -- many independent pairs

Inputs can be S^2 coefficient vectors (B, 2B-1) or raw grid samples
(2B, 2B) -- samples enter through :func:`repro_torch.so3.s2.s2_analysis`.
Everything runs on the plan's device: the correlation grids stay there,
and :func:`peak_euler` takes the argmax on the device and fetches only
the peak's index and its 7-point stencil to the host.

Every :class:`MatchResult` carries the raw correlation ``peak`` and the
normalized cross-correlation ``score`` = peak / (||f|| ||g||), in [-1, 1].
Norms, coefficients and the argmax are computed per request, so a
request's result does not depend on how many requests share its launch:
batched results equal direct ones bit for bit (:func:`result_key`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import plan as plan_mod
from repro_torch.core import quadrature, soft
from repro_torch.plan.transform import _DEF_TK

from . import s2

__all__ = ["MatchResult", "CorrelationEngine", "correlate", "angle_error",
           "random_rotation", "result_key", "peak_euler", "pair_norm"]


def result_key(res: "MatchResult") -> tuple:
    """Bitwise-comparable fingerprint of a MatchResult: the grid argmax
    plus the exact float bit patterns of the refined angles, peak, and
    score.  Two results are the same computation iff their keys are
    equal -- the serving tier's parity oracle: batched-lane results are
    held to direct unbatched execution with it."""
    def bits(x):
        return None if x is None else float(x).hex()
    return (res.index, bits(res.alpha), bits(res.beta), bits(res.gamma),
            bits(res.peak), bits(res.score))


def angle_error(est: float, true: float) -> float:
    """Distance between two angles on the circle."""
    d = abs(est - true) % (2 * np.pi)
    return min(d, 2 * np.pi - d)


def random_rotation(seed_or_rng=0, beta_margin: float = 0.2):
    """Random ZYZ Euler angles with beta kept `beta_margin` clear of the
    (0, pi) endpoints; the same draws as the reference's sampler."""
    rng = (seed_or_rng if isinstance(seed_or_rng, np.random.Generator)
           else np.random.default_rng(seed_or_rng))
    return (float(rng.uniform(0, 2 * np.pi)),
            float(rng.uniform(beta_margin, np.pi - beta_margin)),
            float(rng.uniform(0, 2 * np.pi)))


@dataclasses.dataclass(frozen=True)
class MatchResult:
    """One recovered rotation: Euler angles (ZYZ, repo convention), the
    raw correlation peak, the grid argmax, and the normalized
    cross-correlation score (peak / (||f|| ||g||), in [-1, 1]; None when
    the norms were unavailable or zero)."""

    alpha: float
    beta: float
    gamma: float
    peak: float
    index: tuple[int, int, int]
    score: float | None = None

    @property
    def euler(self) -> tuple[float, float, float]:
        return (self.alpha, self.beta, self.gamma)

    @property
    def rank_key(self) -> float:
        """Cross-template ranking value: the normalized score when
        available, else the raw peak."""
        return self.peak if self.score is None else self.score


def _parabolic_offset(ym: float, y0: float, yp: float) -> float:
    """Sub-grid offset of a quadratic through three equispaced samples,
    clamped to half a grid step (0 when the stencil is degenerate)."""
    den = ym - 2.0 * y0 + yp
    if den == 0.0 or not np.isfinite(den):
        return 0.0
    return float(np.clip(0.5 * (ym - yp) / den, -0.5, 0.5))


def peak_euler(C, B: int, refine: bool = True,
               norm: float | None = None) -> MatchResult:
    """Argmax of Re C over the (2B)^3 Euler grid -> MatchResult.

    The argmax (the first maximal flat index, as ``np.argmax`` takes it)
    and the 7-point stencil around it are taken where C lies; one
    transfer brings those 8 numbers to the host, and the refinement runs
    on Python floats as in the reference: a 1-D quadratic per axis
    through the peak (periodic wrap on alpha / gamma; beta skips
    refinement at the grid edges).  `norm` = ||f|| ||g|| of the
    correlated pair; when given (and nonzero) the result carries
    score = peak / norm.
    """
    C = torch.as_tensor(C)
    Cr = C.real                                    # a view, conj or not
    n = 2 * B
    with torch.profiler.record_function("so3.peak_euler"):
        flat = torch.argmax(Cr)
        i, j, k = flat // (n * n), (flat // n) % n, flat % n
        at = torch.stack([
            flat,
            ((i - 1) % n) * n * n + j * n + k,
            ((i + 1) % n) * n * n + j * n + k,
            i * n * n + j * n + (k - 1) % n,
            i * n * n + j * n + (k + 1) % n,
            i * n * n + (j - 1).clamp(min=0) * n + k,
            i * n * n + (j + 1).clamp(max=n - 1) * n + k])
        vals = torch.take(Cr, at).to(torch.float64)
        y0, am, ap, gm, gp, bm, bp, idx = torch.cat(
            [vals, flat.to(torch.float64).reshape(1)]).tolist()
    idx = int(idx)
    i, j, k = idx // (n * n), (idx // n) % n, idx % n
    a = float(quadrature.alphas(B)[i])
    b = float(quadrature.betas(B)[j])
    g = float(quadrature.gammas(B)[k])
    if refine:
        step_ag = np.pi / B
        step_b = np.pi / (2 * B)
        a += step_ag * _parabolic_offset(am, y0, ap)
        g += step_ag * _parabolic_offset(gm, y0, gp)
        if 0 < j < n - 1:
            b += step_b * _parabolic_offset(bm, y0, bp)
        a %= 2 * np.pi
        g %= 2 * np.pi
    score = y0 / norm if norm else None
    return MatchResult(alpha=a, beta=b, gamma=g, peak=y0, index=(i, j, k),
                       score=score)


def pair_norm(f: torch.Tensor, g: torch.Tensor) -> float:
    """||f|| ||g|| over the coefficient vectors (one transfer) -- the
    normalizer that makes correlation peaks comparable across templates
    (NCC score)."""
    nf, ng = torch.stack([torch.linalg.vector_norm(f),
                          torch.linalg.vector_norm(g)]).tolist()
    return nf * ng


class CorrelationEngine:
    """Batched SO(3) correlation at one bandwidth, executing on a
    :class:`repro_torch.plan.Transform`.

    Build from a plan -- ``repro_torch.plan(B).engine()`` or
    ``CorrelationEngine(transform=t)`` -- so the engine inherits the
    plan's schedule, lane width V and device.  The keyword form
    ``CorrelationEngine(B, dtype=, lane_width=, impl=, device=)`` fetches
    the equivalent Transform from the plan cache (``lane_width=None``:
    V from the plan's rule; ``device=None``: the card).  The port's plans
    fix the cluster tile at 8, so ``tk`` accepts only 8 (or None).

    Distributed matching: hand the engine a mesh plan
    (``repro_torch.plan(B, mesh=...).engine()``, or ``mesh=`` / ``axis=``
    in the keyword form) and every correlation batch runs on the plan's
    lane-packed sharded inverse: the pair coefficients are
    cluster-sharded over the mesh, V pairs ride each sharded launch (one
    all-to-all per chunk), and a multi-chunk batch inherits the plan's
    ``overlap`` mode.  Every rank gets every result.
    """

    def __init__(self, B: int | None = None, *, transform=None,
                 dtype=torch.float64, lane_width: int | None = None,
                 impl: str = "fused", tk: int | None = None, device=None,
                 mesh=None, axis=("data", "model")):
        if tk is not None and tk != _DEF_TK:
            raise ValueError(f"tk={tk}: the port's plans fix the cluster "
                             f"tile at {_DEF_TK}")
        if transform is None:
            if B is None:
                raise ValueError("CorrelationEngine needs B or transform")
            if lane_width is not None and lane_width < 1:
                raise ValueError(
                    f"lane_width must be >= 1, got {lane_width}")
            transform = plan_mod.plan(
                B, dtype, impl=impl,
                V="auto" if lane_width is None else lane_width,
                device=device, mesh=mesh, axis=axis)
        elif B is not None and B != transform.B:
            raise ValueError(f"B={B} conflicts with transform.B="
                             f"{transform.B}")
        self.transform = transform
        self.B = transform.B
        self.lane_width = transform.V
        self.impl = transform.impl
        self.device = transform.device
        self._cdtype = transform.cdtype
        self._invalid = torch.as_tensor(~soft.coeff_mask(self.B),
                                        device=self.device)
        self.reset_stats()

    def reset_stats(self) -> None:
        """Zero the launch/transform counters (e.g. after a warmup)."""
        self.stats = dict(launches=0, transforms=0, padded_lanes=0)

    # -- input normalization ------------------------------------------------

    def as_coeffs(self, x) -> torch.Tensor:
        """Accept S^2 coefficients (B, 2B-1) or grid samples (2B, 2B);
        returns coefficients on the engine's device."""
        x = s2.as_device_tensor(x, self.device)
        B = self.B
        if x.shape == (2 * B, 2 * B):
            x = s2.s2_analysis(x, B)
        if x.shape != (B, 2 * B - 1):
            raise ValueError(
                f"expected S^2 coefficients ({B}, {2 * B - 1}) or samples "
                f"({2 * B}, {2 * B}), got {tuple(x.shape)}")
        return x.to(self._cdtype)

    # -- correlation grids --------------------------------------------------

    def correlation_grids(self, fs, gs) -> torch.Tensor:
        """(N, B, 2B-1) x (N, B, 2B-1) coeff stacks -> (N, 2B, 2B, 2B)
        correlation grids C_n(R) = <f_n, Lambda(R) g_n> on the device.

        T[n, l, m, m'] = conj(f_n[l, m]) g_n[l, m'] on the valid cells
        (zero elsewhere) is built in one buffer; chunks of ``lane_width``
        requests run as ONE lane-packed iFSOFT launch through the plan's
        ``inverse_batch`` (a partial chunk is zero-padded).  The result
        is torch's lazy conjugate view of the inverse (``.resolve_conj()``
        materializes it); Re C, all that matching reads, needs no copy.
        Launch accounting lands in THIS engine's ``stats``.  The pair
        build and :func:`peak_euler` are ``torch.profiler`` ranges
        ("so3.pair_coeffs", "so3.peak_euler").
        """
        B = self.B
        with torch.profiler.record_function("so3.pair_coeffs"):
            T = torch.empty((len(fs), B, 2 * B - 1, 2 * B - 1),
                            dtype=self._cdtype, device=self.device)
            for n, (f, g) in enumerate(zip(fs, gs)):
                torch.mul(f.conj()[:, :, None], g[:, None, :], out=T[n])
            T.masked_fill_(self._invalid, 0)
        return self.transform.inverse_batch(T, stats=self.stats).conj()

    # -- matching entry points ----------------------------------------------

    def match(self, f, g, *, refine: bool = True) -> MatchResult:
        """Rotation maximizing <f, Lambda(R) g> for one pair."""
        return self.match_batch([f], [g], refine=refine)[0]

    def match_batch(self, fs, gs, *, refine: bool = True) -> list[MatchResult]:
        """Many independent (f_n, g_n) pairs -> one MatchResult each,
        scored by normalized cross-correlation.  Runs one launch group of
        ``lane_width`` pairs at a time, so at most one group's grids are
        live on the device."""
        fs = [self.as_coeffs(f) for f in fs]
        gs = [self.as_coeffs(g) for g in gs]
        if len(fs) != len(gs):
            raise ValueError(f"got {len(fs)} queries vs {len(gs)} templates")
        out = []
        V = self.lane_width
        for n0 in range(0, len(fs), V):
            C = self.correlation_grids(fs[n0:n0 + V], gs[n0:n0 + V])
            out += [peak_euler(C[n], self.B, refine=refine,
                               norm=pair_norm(fs[n0 + n], gs[n0 + n]))
                    for n in range(C.shape[0])]
            del C
        return out

    def match_bank(self, f, bank, *, refine: bool = True
                   ) -> tuple[int, list[MatchResult]]:
        """One query f against a template bank -> (best index, per-template
        results).  The winner is picked by the normalized score
        (peak / (||f|| ||g||)), so templates of different power compete
        fairly."""
        if not len(bank):
            raise ValueError("empty template bank")
        f = self.as_coeffs(f)
        results = self.match_batch([f] * len(bank), list(bank), refine=refine)
        best = int(np.argmax([r.rank_key for r in results]))
        return best, results


def correlate(f, g, B: int, *, refine: bool = True, **engine_kw) -> MatchResult:
    """One-shot convenience wrapper: build an engine, match one pair."""
    return CorrelationEngine(B, **engine_kw).match(f, g, refine=refine)
