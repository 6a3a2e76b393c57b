"""The port's LM serving path (repro_torch.configs, models, launch.serve)
against the reference package on identical weights and tokens.

Weights come from the reference's ``lm.init`` and reach the port through
``models.convert.params_from_numpy``; prompts and decode tokens are made
with numpy.  Tolerances, as a share of max|logit| (and of max|state| for
the KV caches):
  * float32: 1e-4.  Both packages compute every layer in f32; they differ
    by summation order, XLA's against torch's transcendental functions,
    and the reference's single-pass softmax against the kernel's online
    softmax (measured 0.9e-6 to 4.7e-6).  The greedy tokens must be equal.
  * bfloat16: 5e-2.  Activations round to bf16 at every layer
    (2**-8 relative a rounding), the two packages round at slightly other
    places, and the kernel rounds p to bf16 before P V where the
    reference's jnp prefill does not (measured 0.9e-2 to 1.6e-2).  Tokens
    are not compared: a near tie may go either way.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import convert, layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ARCH = "smollm-135m"


def _configs(dtype):
    """The reduced smollm-135m of both packages, in ``dtype``."""
    cj, ct = jconfigs.reduced(ARCH), tconfigs.reduced(ARCH)
    if dtype != "float32":
        cj = dataclasses.replace(cj, param_dtype=dtype, compute_dtype=dtype)
        ct = dataclasses.replace(ct, param_dtype=dtype, compute_dtype=dtype)
    return cj, ct


def _models(dtype, seed=0):
    cj, ct = _configs(dtype)
    params = jlm.init(cj, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, params)
    return cj, params, tree, convert.params_from_numpy(ct, tree, "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_equal_field_by_field():
    for get in ("get", "reduced"):
        j = getattr(jconfigs, get)(ARCH)
        t = getattr(tconfigs, get)(ARCH)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.q_dim, t.kv_dim, t.layer_kinds()) == \
            (j.q_dim, j.kv_dim, j.layer_kinds())
        assert [s.name for s in tbase.shapes_for(t)] == \
            [s.name for s in jbase.shapes_for(j)]
        assert tbase.sub_quadratic(t) == jbase.sub_quadratic(j)
    assert [dataclasses.asdict(s) for s in tbase.LM_SHAPES] == \
        [dataclasses.asdict(s) for s in jbase.LM_SHAPES]
    moe = tbase.MoEConfig(num_experts=8, top_k=2)
    assert dataclasses.asdict(moe) == dataclasses.asdict(
        jbase.MoEConfig(num_experts=8, top_k=2))


def test_registry_lists_only_ported_archs():
    """Every architecture of the reference is ported: the registry is the
    reference's, in its order, and each config equals the reference's
    field for field (published and reduced)."""
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert not hasattr(tconfigs, "NOT_PORTED")
    for name in tconfigs.ARCH_NAMES:
        for get in ("get", "reduced"):
            assert dataclasses.asdict(getattr(tconfigs, get)(name)) == \
                dataclasses.asdict(getattr(jconfigs, get)(name)), (name, get)
    with pytest.raises(KeyError):
        tconfigs.get("no-such-arch")


def test_count_params_full_smollm_on_meta():
    cfg = tconfigs.get(ARCH)
    assert tlm.count_params(cfg) == jlm.count_params(jconfigs.get(ARCH))
    model = tlm.LM(cfg, device="meta")
    assert all(p.is_meta for p in model.parameters())


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "sqrelu"])
def test_mlp_matches_reference(kind):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    wi = rng.normal(size=(16, 64 if kind in tlayers.GATED else 32)) \
        .astype(np.float32) / 4
    wo = rng.normal(size=(32, 16)).astype(np.float32) / 6
    want = jlayers.mlp_apply({"wi": jnp.asarray(wi), "wo": jnp.asarray(wo)},
                             jnp.asarray(x), kind)
    got = tlayers.mlp_apply(*(torch.from_numpy(a) for a in (x, wi, wo)),
                            kind)
    assert _rel(got, want) < 1e-5


def test_norms_rope_softcap_match_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 3, 32)).astype(np.float32)
    scale = rng.normal(size=32).astype(np.float32) / 10
    bias = rng.normal(size=32).astype(np.float32) / 10
    xt, st, bt = (torch.from_numpy(a) for a in (x, scale, bias))
    assert _rel(tlayers.rmsnorm(xt, st), jlayers.rmsnorm(
        {"scale": jnp.asarray(scale)}, jnp.asarray(x))) < 1e-6
    assert _rel(tlayers.layernorm(xt, st, bt), jlayers.layernorm(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        jnp.asarray(x))) < 1e-6
    pos = np.arange(6, dtype=np.int32)[None].repeat(2, 0) * 7
    assert np.array_equal(tlayers._rope_freqs(32, 10000.0),
                          jlayers._rope_freqs(32, 10000.0))
    assert _rel(tlayers.rope(xt, torch.from_numpy(pos)), jlayers.rope(
        jnp.asarray(x), jnp.asarray(pos))) < 1e-5
    pos3 = np.stack([pos, pos + 1, pos * 2])
    assert _rel(tlayers.mrope(xt, torch.from_numpy(pos3), (4, 6, 6)),
                jlayers.mrope(jnp.asarray(x), jnp.asarray(pos3),
                              (4, 6, 6))) < 1e-5
    assert _rel(tlayers.softcap(xt * 40, 30.0),
                jlayers.softcap(jnp.asarray(x) * 40, 30.0)) < 1e-6
    assert tlayers.softcap(xt, 0.0) is xt


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy(dtype):
    """Every weight reaches its parameter bit for bit, bf16 included
    (through a uint16 view, without the bfloat16 numpy extension)."""
    cj, params, tree, model = _models(dtype)
    want_dtype = tlayers.dtype_of(dtype)
    assert model.embed.dtype == want_dtype
    assert np.array_equal(_f32(model.embed),
                          np.asarray(tree["embed"], np.float32))
    for i, block in enumerate(model.blocks):
        g, slot = divmod(i, len(cj.block_pattern))
        ref = jax.tree.map(lambda a: a[g], tree["groups"][slot])
        for name, got in (("wq", block.mixer.wq), ("wo", block.mixer.wo),
                          ("wi", block.mlp.wi)):
            w = ref["mixer" if name != "wi" else "mlp"][name]
            assert got.dtype == want_dtype
            assert np.array_equal(_f32(got), np.asarray(w, np.float32))
        assert block.norm1.scale.dtype == torch.float32
    assert tlm.count_params(_configs(dtype)[1]) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(tree))


# ---------------------------------------------------------------------------
# serving: prefill, decode, generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [32, 40])     # 40: the padded prefill
def test_serve_matches_reference(dtype, S):
    """Prefill logits and KV caches, 8 decode steps, and the greedy
    tokens of serve.generate, against repro.models.lm /
    repro.launch.serve."""
    cj, params, _, model = _models(dtype, seed=S)
    rng = np.random.default_rng(S)
    B, steps = 2, 8
    toks = rng.integers(1, cj.vocab_size, (B, S)).astype(np.int32)
    max_len = S + steps
    jl, jst = jax.jit(lambda p, t: jlm.prefill(p, cj, {"tokens": t},
                                               max_len))(params, toks)
    tl, tst = model.prefill(torch.from_numpy(toks).long(), max_len)
    assert tl.dtype == torch.float32 and tl.shape == (B, cj.vocab_size)
    assert _rel(tl, jl) < TOL[dtype]
    for key in ("k", "v"):
        got = torch.stack([st[key] for st in tst])
        assert got.dtype == tlayers.dtype_of(dtype)
        assert _rel(got, jst["groups"][0][key]) < TOL[dtype]

    step = jax.jit(lambda p, t, st, pos: jlm.decode_step(
        p, cj, {"tokens": t}, st, pos))
    for i in range(steps):
        tok = rng.integers(1, cj.vocab_size, (B, 1)).astype(np.int32)
        jl, jst = step(params, tok, jst, jnp.int32(S + i))
        tl, tst = model.decode_step(torch.from_numpy(tok).long(), tst, S + i)
        assert _rel(tl, jl) < TOL[dtype], i

    got = tserve.generate(model, torch.from_numpy(toks).long(), steps)
    assert got.shape == (B, steps)
    if dtype == "float32":
        want = np.asarray(jserve.generate(cj, params, jnp.asarray(toks),
                                          steps))
        assert np.array_equal(got.numpy(), want)


def test_serve_main_on_cpu(capsys):
    out = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "20", "--tokens",
                       "4"])
    assert out.shape == (2, 4)
    assert "generated 2x4 tokens" in capsys.readouterr().out


def test_sampling_takes_first_maximum():
    logits = torch.tensor([[1.0, 3.0, 3.0], [2.0, 2.0, 0.0]])
    assert tserve.sample(logits).tolist() == [1, 0]
    assert np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)).tolist() \
        == [1, 0]
    g = torch.Generator().manual_seed(0)
    drawn = tserve.sample(logits, 1.0, g)
    assert drawn.shape == (2,) and drawn[0] in (0, 1, 2)


def test_unported_paths_raise():
    """A model built with no device asks for the card (every module of
    the reference is ported; the sharded paths are held to the
    reference's in tests/test_torch_moe_sharded.py and
    tests/test_torch_lm_sharded.py)."""
    from repro_torch.models import moe as tmoe
    cfg = tconfigs.reduced(ARCH)
    mcfg = tconfigs.reduced("olmoe-1b-7b")
    layer = tmoe.MoE(mcfg, torch.float32, torch.Generator().manual_seed(0))
    x = torch.zeros((1, 4, mcfg.d_model))
    assert tmoe.moe_apply(layer, x)[0].shape == x.shape
    if not torch.cuda.is_available():     # no device given: the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlm.init(cfg, torch.Generator())


def test_state_init_and_init_on_cpu():
    cfg = tconfigs.reduced(ARCH)
    states = tlm.state_init(cfg, 2, 16, device="cpu")
    assert len(states) == cfg.num_layers
    assert states[0]["k"].shape == (2, 16, cfg.num_kv_heads, cfg.head_dim)
    model = tlm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    logits, _ = model.decode_step(torch.ones((2, 1), dtype=torch.long),
                                  states, 0)
    assert logits.shape == (2, cfg.vocab_size)
    assert torch.isfinite(logits).all()
