"""The port's training forward and loss (repro_torch.models.lm.forward /
loss_fn) against the reference's (jax.value_and_grad of
repro.models.lm.loss_fn) for every architecture's reduced config, on
identical weights (``params_from_numpy`` of the reference's ``lm.init``)
and numpy batches, in float32.

Tolerances: the loss within rtol 1e-5; every gradient leaf (stacked as
the reference stacks it, ``convert.tree_to_numpy(grads=True)``) within
1e-4 of max|reference leaf| (the readings reach 1.5e-5 at rwkv6-3b's
sequential scan, 5e-6 elsewhere: float32 sums in another order)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import convert, lm as tlm  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: its tensors are small, and beside
    other test workers a thread pool mostly waits for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.embed_inputs:
        out["embeds"] = (rng.normal(size=(B, S, cfg.d_model)) * 0.02) \
            .astype(np.float32)
    else:
        out["tokens"] = rng.integers(1, cfg.vocab_size, (B, S)) \
            .astype(np.int32)
    if cfg.pos_type == "mrope":
        out["positions"] = np.tile(np.arange(S, dtype=np.int32), (3, B, 1))
    out["labels"] = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    return out


def _port_grads(cfg, tree, batch):
    model = convert.params_from_numpy(cfg, tree, "cpu").trainable()
    loss = tlm.loss_fn(model, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), convert.tree_to_numpy(model, grads=True)


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_loss_and_every_gradient_match_reference(arch):
    cj, ct = jconfigs.reduced(arch), tconfigs.reduced(arch)
    params = jlm.init(cj, jax.random.key(1))
    tree = jax.tree.map(np.asarray, params)
    batch = _batch(cj, seed=len(arch))
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, cj, b)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    lt, gt = _port_grads(ct, tree, batch)
    assert np.isfinite(lt)
    assert lt == pytest.approx(float(lj), rel=LOSS_RTOL)
    jflat = jax.tree_util.tree_flatten_with_path(gj)[0]
    tflat = jax.tree_util.tree_flatten_with_path(gt)[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, want), (_, got) in zip(jflat, tflat):
        want = np.asarray(want)
        assert got.shape == want.shape, path
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= GRAD_TOL, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-9b"])
def test_remat_policies_give_equal_grads(arch):
    """remat none / block / nested (sqrt(G) segments) recompute the same
    operations: equal losses and gradients, bit for bit.  smollm's
    reduced config has G = 4 groups (nested: 2 segments of 2);
    recurrentgemma's 3-slot pattern leaves tail layers outside every
    group."""
    base = dataclasses.replace(tconfigs.reduced(arch), num_layers=8)
    gen = torch.Generator().manual_seed(3)
    tree = convert.tree_to_numpy(tlm.init(base, gen, "cpu"))
    batch = _batch(base, seed=5)
    runs = {r: _port_grads(dataclasses.replace(base, remat=r), tree, batch)
            for r in ("none", "block", "nested")}
    for r in ("block", "nested"):
        assert runs[r][0] == runs["none"][0], r
        for a, b in zip(jax.tree.leaves(runs[r][1]),
                        jax.tree.leaves(runs["none"][1])):
            np.testing.assert_array_equal(a, b)


def test_forward_is_the_final_hidden_state():
    """forward returns the final-normed hidden states and the summed MoE
    aux loss (0 without MoE; positive with it)."""
    for arch, has_aux in (("smollm-135m", False), ("olmoe-1b-7b", True)):
        cfg = tconfigs.reduced(arch)
        model = tlm.init(cfg, torch.Generator().manual_seed(0), "cpu")
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1).items()}
        x, aux = tlm.forward(model, batch)
        assert x.shape == (B, S, cfg.d_model) and x.dtype == torch.float32
        assert (float(aux) > 0) == has_aux


def test_trainable_switch_leaves_serving_without_grad():
    cfg = tconfigs.reduced("smollm-135m")
    model = tlm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in model.parameters())
    model.trainable()
    assert all(p.requires_grad for p in model.parameters())
    tokens = torch.randint(1, cfg.vocab_size, (2, 8))
    logits, states = model.prefill(tokens, 16)
    assert not logits.requires_grad
    assert not any(t.requires_grad for st in states for t in st.values())


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-3b"])
def test_device_and_dtype_moves_keep_the_recurrent_blocks(arch):
    """Module.to / .float recurse through every child's nn.Module._apply;
    the recurrent mixers must leave that method alone.  A move to the
    device the model is on changes nothing (equal loss); .float() gives
    float32 parameters, and training and serving still run."""
    cfg = tconfigs.reduced(arch)
    model = tlm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2).items()}
    before = tlm.loss_fn(model, batch)
    assert model.to("cpu") is model
    assert torch.equal(tlm.loss_fn(model, batch), before)
    model.float()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert torch.isfinite(tlm.loss_fn(model, batch))
    logits, _ = model.prefill(batch["tokens"][:, :8], 16)
    assert logits.shape == (B, cfg.vocab_size)
    assert torch.isfinite(logits).all()
