"""The port's RG-LRU mixer (repro_torch.models.rglru) against the
reference's (repro.models.rglru and repro.models.lm._rglru_prefill) on
identical weights and inputs made with numpy.

Tolerances, as a share of max|reference| (the existing LM tolerance of
tests/test_torch_lm.py): float32 1e-4, bfloat16 5e-2.  The prefill's
scan is a log-depth doubling scan in torch and XLA's associative_scan in
the reference: the same products and sums, grouped otherwise."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ARCH = "recurrentgemma-9b"


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _load(module, tree):
    """Copy the reference's leaves into the module's same-named
    parameters (bf16 through a float32 round trip: exact)."""
    names = dict(module.named_parameters())
    assert set(names) == set(tree)
    for name, a in tree.items():
        t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
        names[name].data.copy_(t.to(names[name].dtype))


def _pair(dtype, seed=0):
    cfg = tconfigs.reduced(ARCH)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    p = jrg.rglru_init(jax.random.key(seed), jconfigs.reduced(ARCH), jdt)
    mod = trg.RGLRU(cfg, tlayers.dtype_of(dtype))
    _load(mod, p)
    return cfg, p, mod


def _x(shape, dtype, seed):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(
        tlayers.dtype_of(dtype))


def test_init_matches_reference_shapes_and_lambda():
    cfg, p, mod = _pair("float32")
    fresh = trg.RGLRU(cfg, torch.float32, torch.Generator().manual_seed(0))
    for name, a in p.items():
        got = getattr(fresh, name)
        assert tuple(got.shape) == a.shape and \
            got.dtype == tlayers.dtype_of(str(a.dtype)), name
    assert np.array_equal(fresh.lam.numpy(), np.asarray(p["lam"]))
    assert not fresh.b_a.any() and not fresh.b_x.any()


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
def test_linear_scan_matches_associative_scan(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 16)).astype(np.float32)
    b = rng.normal(size=(2, S, 16)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    got = trg.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert _rel(got, want) < TOL["float32"]
    seq = np.zeros((2, 16), np.float32)
    for t in range(S):                  # the recurrence itself, in order
        seq = a[:, t] * seq + b[:, t]
    assert np.abs(got[:, -1].numpy() - seq).max() < 1e-5 * \
        max(np.abs(seq).max(), 1)


def test_conv_and_gates_match_reference():
    cfg, p, mod = _pair("float32", seed=1)
    jx, tx = _x((2, 9, cfg.d_model), "float32", 1)
    assert _rel(mod._causal_conv(tx), jrg._causal_conv(p, jx)) < 1e-6
    ja, jg = jrg._gates(p, jx)
    ta, tg = mod._gates(tx)
    assert _rel(ta, ja) < 1e-6 and _rel(tg, jg) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [3, 40])
def test_prefill_and_decode_match_reference(dtype, S):
    """The prefill's output and its final (h, conv) state against
    _rglru_prefill (and rglru_apply), then 6 decode steps against
    rglru_step."""
    cfg, p, mod = _pair(dtype, seed=S)
    jx, tx = _x((2, S, cfg.d_model), dtype, S)
    jout, jst = jlm._rglru_prefill(p, jx, jconfigs.reduced(ARCH))
    tout, tst = mod.prefill(tx)
    assert tout.dtype == tlayers.dtype_of(dtype)
    assert _rel(tout, jout) < TOL[dtype]
    assert _rel(tout, jrg.rglru_apply(p, jx, None)) < TOL[dtype]
    assert tst["h"].dtype == torch.float32
    assert _rel(tst["h"], jst["h"]) < TOL[dtype]
    assert _rel(tst["conv"], jst["conv"]) < TOL[dtype]
    for i in range(6):
        jx1, tx1 = _x((2, 1, cfg.d_model), dtype, 100 + i)
        jy, jst = jrg.rglru_step(p, jx1, None, jst)
        ty, tst = mod.decode_step(tx1, tst)
        assert _rel(ty, jy) < TOL[dtype], i
        assert _rel(tst["h"], jst["h"]) < TOL[dtype], i
        assert _rel(tst["conv"], jst["conv"]) < TOL[dtype], i


def test_state_init_matches_reference():
    cfg = tconfigs.reduced(ARCH)
    want = jrg.state_init(jconfigs.reduced(ARCH), 3, jnp.float32)
    got = trg.state_init(cfg, 3, torch.float32, "cpu")
    for k, a in want.items():
        assert tuple(got[k].shape) == a.shape and not got[k].any()
    assert got["h"].dtype == torch.float32
