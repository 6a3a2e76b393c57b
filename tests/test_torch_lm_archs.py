"""The port's LM serving path for every architecture (repro_torch.configs,
models, launch.serve) against the reference package on identical weights
and inputs.

Weights come from the reference's ``lm.init`` and reach the port through
``models.convert.params_from_numpy``; prompts, frontend embeddings and
decode inputs are made with numpy.  Prompt 40 covers the attention
kernel's padded prefill (bq 32, padded to 64), recurrentgemma's ring
(window 32: the prefill rolls, the decode wraps) and the recurrent
states.  Tolerances are those of tests/test_torch_lm.py, as a share of
max|reference|: float32 1e-4, bfloat16 5e-2.  float32 greedy tokens must
be equal."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import convert, layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
NEW = tuple(a for a in jconfigs.ARCH_NAMES if a != "smollm-135m")
B, S, STEPS = 2, 40, 8


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _configs(arch, dtype="float32", **over):
    cj, ct = jconfigs.reduced(arch), tconfigs.reduced(arch)
    if dtype != "float32":
        over.update(param_dtype=dtype, compute_dtype=dtype)
    return dataclasses.replace(cj, **over), dataclasses.replace(ct, **over)


def _inputs(cfg, n, seed):
    """{"tokens"} or {"embeds"}, plus (3, B, n) positions for M-RoPE, as
    numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.embed_inputs:
        out["embeds"] = (rng.normal(size=(B, n, cfg.d_model)) * 0.02) \
            .astype(np.float32)
    else:
        out["tokens"] = rng.integers(1, cfg.vocab_size, (B, n)) \
            .astype(np.int32)
    if cfg.pos_type == "mrope":
        out["positions"] = np.tile(np.arange(n, dtype=np.int32), (3, B, 1))
    return out


def _port_kw(batch):
    """The port's (tokens, keyword arguments) of a numpy batch."""
    tokens = batch.get("tokens")
    kw = {k: torch.from_numpy(batch[k]) for k in ("embeds", "positions")
          if k in batch}
    return (None if tokens is None else torch.from_numpy(tokens).long()), kw


@functools.lru_cache(maxsize=None)
def _models(arch, dtype="float32", seed=0):
    cj, ct = _configs(arch, dtype)
    params = jlm.init(cj, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, params)
    return cj, ct, params, tree, convert.params_from_numpy(ct, tree, "cpu")


def _layer_states(cfg, st):
    """The reference's {"groups": [stacked], "tail": [...]} states as one
    dict per layer, in layer order."""
    pat = cfg.block_pattern
    G = cfg.num_layers // len(pat)
    out = [jax.tree.map(lambda a: a[g], st["groups"][slot])
           for g in range(G) for slot in range(len(pat))]
    return out + list(st["tail"])


@functools.lru_cache(maxsize=None)
def _reference_run(arch, dtype="float32"):
    """The reference's prefill and STEPS decode steps on seeded inputs:
    (batch, decode inputs, prefill logits, per-layer states, decode
    logits, states after decode)."""
    cj, _, params, _, _ = _models(arch, dtype)
    batch = _inputs(cj, S, seed=S)
    max_len = S + STEPS
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, states = jax.jit(lambda p, b: jlm.prefill(p, cj, b, max_len))(
        params, jb)
    step = jax.jit(lambda p, b, st, pos: jlm.decode_step(p, cj, b, st, pos))
    steps, outs = [], []
    st = states
    for i in range(STEPS):
        inp = _inputs(cj, 1, seed=100 + i)
        inp.pop("positions", None)
        out, st = step(params, {k: jnp.asarray(v) for k, v in inp.items()},
                       st, jnp.int32(S + i))
        steps.append(inp)
        outs.append(out)
    return (batch, steps, logits, _layer_states(cj, states), outs,
            _layer_states(cj, st))


def _assert_states(got, want, tol, where):
    assert len(got) == len(want), where
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (where, i)
        for key in w:
            assert tuple(g[key].shape) == tuple(w[key].shape), (where, i, key)
            assert _rel(g[key], w[key]) < tol, (where, i, key)


# ---------------------------------------------------------------------------
# prefill, decode, generate against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW)
def test_prefill_logits_and_states_match_reference(arch):
    """Prefill logits and every layer's decode state (KV cache or ring,
    RG-LRU (h, conv), RWKV-6 (S, x_prev)) against repro.models.lm."""
    cj, ct, _, _, model = _models(arch)
    batch, _, jl, jst, _, _ = _reference_run(arch)
    tokens, kw = _port_kw(batch)
    tl, tst = model.prefill(tokens, S + STEPS, **kw)
    assert tl.dtype == torch.float32 and tl.shape == (B, ct.vocab_size)
    assert _rel(tl, jl) < TOL["float32"]
    _assert_states(tst, jst, TOL["float32"], arch)


@pytest.mark.parametrize("arch", NEW)
def test_decode_steps_match_reference(arch):
    """8 decode steps after the prefill: every step's logits and the
    states after the last (recurrentgemma's ring wraps: positions 40..47
    in 32 slots)."""
    cj, ct, _, _, model = _models(arch)
    batch, steps, _, _, jouts, jst = _reference_run(arch)
    tokens, kw = _port_kw(batch)
    _, tst = model.prefill(tokens, S + STEPS, **kw)
    for i, (inp, jl) in enumerate(zip(steps, jouts)):
        t, k = _port_kw(inp)
        tl, tst = model.decode_step(t, tst, S + i, **k)
        assert _rel(tl, jl) < TOL["float32"], i
    _assert_states(tst, jst, TOL["float32"], arch)


def _reference_generate(cfg, params, batch, steps):
    """examples/serve_lm.py's loop for frontend-embedding models (the
    generated token's embedding fed back), jserve.generate otherwise."""
    if not cfg.embed_inputs:
        return np.asarray(jserve.generate(cfg, params,
                                          jnp.asarray(batch["tokens"]),
                                          steps))
    max_len = S + steps
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, st = jlm.prefill(params, cfg, jb, max_len)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out = [tok]
    for i in range(steps - 1):
        emb = params["embed"][tok][:, None].astype(jnp.float32)
        logits, st = jlm.decode_step(params, cfg, {"embeds": emb}, st,
                                     jnp.int32(S + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(tok)
    return np.stack([np.asarray(t) for t in out], axis=1)


@pytest.mark.parametrize("arch", NEW)
def test_generate_greedy_tokens_match_reference(arch):
    cj, _, params, _, model = _models(arch)
    batch = _reference_run(arch)[0]
    tokens, kw = _port_kw(batch)
    got = tserve.generate(model, tokens, STEPS, **kw)
    assert got.shape == (B, STEPS) and got.dtype == torch.int64
    assert np.array_equal(got.numpy(),
                          _reference_generate(cj, params, batch, STEPS))


def test_recurrentgemma_bf16_matches_reference():
    """bf16 weights and activations: prefill logits, states and 8 decode
    steps of the hybrid (RG-LRU, ring, soft caps) within 5e-2."""
    arch = "recurrentgemma-9b"
    _, _, _, _, model = _models(arch, "bfloat16")
    batch, steps, jl, jst, jouts, _ = _reference_run(arch, "bfloat16")
    tokens, kw = _port_kw(batch)
    tl, tst = model.prefill(tokens, S + STEPS, **kw)
    assert model.embed.dtype == torch.bfloat16
    assert _rel(tl, jl) < TOL["bfloat16"]
    _assert_states(tst, jst, TOL["bfloat16"], arch)
    for i, (inp, want) in enumerate(zip(steps, jouts)):
        t, k = _port_kw(inp)
        tl, tst = model.decode_step(t, tst, S + i, **k)
        assert _rel(tl, want) < TOL["bfloat16"], i


@pytest.mark.parametrize("arch", NEW)
def test_decode_matches_prefill(arch):
    """The reference's tests/test_arch_smoke.py::test_decode_matches_prefill
    on the port: prefill(S) then decoding token S gives prefill(S+1)'s
    last logits (MoE dropless, capacity factor 16, as there)."""
    cj, ct = _configs(arch)
    if ct.moe is not None:
        moe = dataclasses.replace(ct.moe, capacity_factor=16.0)
        cj, ct = (dataclasses.replace(c, moe=moe) for c in (cj, ct))
    params = jlm.init(cj, jax.random.key(1))
    model = convert.params_from_numpy(ct, jax.tree.map(np.asarray, params),
                                      "cpu")
    n = 33
    full = _inputs(ct, n + 1, seed=3)
    head = {k: v[..., :n, :] if k == "embeds" else v[..., :n]
            for k, v in full.items()}
    last = {k: v[..., n:, :] if k == "embeds" else v[..., n:]
            for k, v in full.items() if k != "positions"}
    tokens, kw = _port_kw(head)
    _, st = model.prefill(tokens, 64, **kw)
    t, k = _port_kw(last)
    step_logits, _ = model.decode_step(t, st, n, **k)
    tokens, kw = _port_kw(full)
    want, _ = model.prefill(tokens, 64, **kw)
    np.testing.assert_allclose(step_logits.numpy(), want.numpy(),
                               rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# parameter counts and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_param_counts_of_full_configs_on_meta(arch):
    """count_params and count_active_params of the published configs,
    built on the meta device, equal the reference's."""
    cfg = tconfigs.get(arch)
    assert tlm.count_params(cfg) == jlm.count_params(jconfigs.get(arch))
    assert tlm.count_active_params(cfg) == \
        jlm.count_active_params(jconfigs.get(arch))


@pytest.mark.parametrize("arch", NEW)
def test_params_from_numpy_round_trips_every_leaf(arch):
    """Every leaf of the reference's tree reaches the parameter of its
    name bit for bit (layer g len(pattern) + slot of the groups, then the
    tail), and the model has no parameter without a leaf."""
    cj, ct, _, tree, model = _models(arch)
    params = dict(model.named_parameters())
    seen = set()

    def check(name, a):
        got = params[name]
        assert got.dtype == tlayers.dtype_of(str(np.asarray(a).dtype)), name
        assert np.array_equal(got.numpy(), np.asarray(a)), name
        seen.add(name)

    for key in ("embed", "head"):
        if key in tree:
            check(key, tree[key])
    for k, a in tree["final_norm"].items():
        check(f"final_norm.{k}", a)
    layers_ = _layer_states(cj, {"groups": tree["groups"],
                                 "tail": tree["tail"]})
    for i, p in enumerate(layers_):
        for path, a in convert._leaves(p):
            check(f"blocks.{i}.{path}", a)
    assert seen == set(params)


def test_params_from_numpy_rejects_a_missing_or_extra_leaf():
    arch = "olmoe-1b-7b"
    cj, ct, _, tree, _ = _models(arch)
    bad = jax.tree.map(lambda a: a, tree)
    del bad["groups"][0]["moe"]["router"]
    with pytest.raises(ValueError, match="no leaf"):
        convert.params_from_numpy(ct, bad, "cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["groups"][0]["moe"]["extra"] = bad["groups"][0]["moe"]["router"]
    with pytest.raises(ValueError, match="no parameter"):
        convert.params_from_numpy(ct, bad, "cpu")
