"""The port's MoE FFN (repro_torch.models.moe) against the reference's
single-device path (repro.models.moe: _route, _dispatch_indices,
_dispatch_combine, _moe_local) on identical weights and tokens made with
numpy.

The routing is held exactly: expert ids, positions in the expert and the
keep mask are equal (torch.equal), at the published capacity factor with
tokens dropped.  Values: float32 1e-4 and bfloat16 5e-2 of max|reference|
(the existing LM tolerance of tests/test_torch_lm.py); the aux loss
within 1e-6 relative."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# reduced configs at the published capacity factor of their architecture
ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _configs(arch, dtype="float32", capacity_factor=None):
    cf = capacity_factor or jconfigs.get(arch).moe.capacity_factor
    out = []
    for c in (jconfigs, tconfigs):
        cfg = c.reduced(arch)
        cfg = dataclasses.replace(
            cfg, param_dtype=dtype, compute_dtype=dtype,
            moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        out.append(cfg)
    return out


def _pair(arch, dtype="float32", seed=0, capacity_factor=None):
    jcfg, tcfg = _configs(arch, dtype, capacity_factor)
    p = jmoe.moe_init(jax.random.key(seed), jcfg, JDT[dtype])
    mod = tmoe.MoE(tcfg, tlayers.dtype_of(dtype))
    names = dict(mod.named_parameters())
    flat = {k: v for k, v in p.items() if k != "shared"}
    flat.update({f"shared.{k}": v for k, v in p.get("shared", {}).items()})
    assert set(names) == set(flat)
    for name, a in flat.items():
        t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
        names[name].data.copy_(t.to(names[name].dtype))
    return jcfg, tcfg, p, mod


def _x(shape, dtype, seed):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(
        tlayers.dtype_of(dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_and_dispatch_equal_reference(arch):
    """Expert ids, gate values, probabilities; then position and keep mask
    of every (token, slot) entry, exactly, with drops happening."""
    jcfg, tcfg, p, mod = _pair(arch, seed=1)
    jx, tx = _x((64, jcfg.d_model), "float32", 1)
    jg, jid, jprobs = jmoe._route(p["router"], jx, jcfg.moe)
    tg, tid, tprobs = tmoe.route(mod.router, tx, tcfg.moe)
    assert np.array_equal(tid.numpy(), np.asarray(jid))
    assert _rel(tg, jg) < 1e-6 and _rel(tprobs, jprobs) < 1e-6
    E = jcfg.moe.num_experts
    C = tmoe.capacity(64, tcfg.moe)
    assert C == max(int(np.ceil(64 * jcfg.moe.top_k / E
                                * jcfg.moe.capacity_factor)), 1)
    je, jc, jk = jmoe._dispatch_indices(jid, E, C)
    te, tc, tk = tmoe.dispatch_indices(tid, E, C)
    for got, want in ((te, je), (tc, jc), (tk, jk)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(tk.sum()) < tk.numel()          # some entries dropped


def test_route_takes_the_lower_id_on_ties():
    """Equal probabilities: the lower expert id first, as jax.lax.top_k."""
    m = tconfigs.reduced("olmoe-1b-7b").moe
    router = torch.zeros((4, m.num_experts))
    x = torch.ones((3, 4))
    _, ids, _ = tmoe.route(router, x, m)
    _, jids, _ = jmoe._route(jnp.zeros((4, m.num_experts)),
                             jnp.ones((3, 4)), m)
    assert ids.tolist() == np.asarray(jids).tolist() == \
        [list(range(m.top_k))] * 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, dtype):
    """_moe_local's output (shared experts included) and aux loss, at the
    published capacity factor (drops) and dropless."""
    for cf in (None, 16.0):
        jcfg, tcfg, p, mod = _pair(arch, dtype, seed=2,
                                   capacity_factor=cf)
        jx, tx = _x((2, 24, jcfg.d_model), dtype, 2)
        jout, jaux = jmoe.moe_apply(p, jx, jcfg)
        tout, taux = tmoe.moe_apply(mod, tx)
        assert tout.dtype == tlayers.dtype_of(dtype)
        assert _rel(tout, jout) < TOL[dtype], cf
        assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))


def test_expert_ffn_matches_reference():
    rng = np.random.default_rng(3)
    for kind, f in (("swiglu", 16), ("gelu", 8), ("sqrelu", 8)):
        xe, wi, wo = (rng.normal(size=s).astype(np.float32) / 3 for s in (
            (4, 5, 12), (4, 12, f), (4, 8, 12)))
        want = jmoe._expert_ffn(jnp.asarray(wi), jnp.asarray(wo),
                                jnp.asarray(xe), kind)
        got = tmoe.expert_ffn(*(torch.from_numpy(a) for a in (wi, wo, xe)),
                              kind)
        assert _rel(got, want) < 1e-5, kind


def test_init_shapes_match_reference():
    for arch in ARCHS:
        jcfg, tcfg = _configs(arch)
        p = jax.eval_shape(lambda: jmoe.moe_init(jax.random.key(0), jcfg,
                                                 jnp.float32))
        mod = tmoe.MoE(tcfg, torch.float32, torch.Generator().manual_seed(0))
        assert tuple(mod.wi.shape) == p["wi"].shape
        assert tuple(mod.wo.shape) == p["wo"].shape
        assert tuple(mod.router.shape) == p["router"].shape
        assert ("shared" in p) == hasattr(mod, "shared")
