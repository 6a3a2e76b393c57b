"""The port's train step (repro_torch.train.make_train_step) against the
reference's (repro.train.make_train_step) on identical weights and
batches, and the planted faults its tolerances must reject
(tests/test_torch_train_runtime.py holds the data pipeline, checkpoints
and fault tolerance).

make_train_step: three steps of the reduced smollm-135m (float32; 4
layers stacked as G = 4) from the reference's lm.init weights, AdamW and
Adafactor, microbatch 0 and 2, grad_compression none and int8.  Compared
per step: the loss (rtol LOSS_RTOL) and the grad norm; after the last
step: each leaf's total update (params after - params before) and every
optimizer / error-feedback state leaf, as ||port - ref|| / ||ref|| (rel
l2).  Readings: without compression <= 1.9e-5; with int8 <= 5.1e-3
(an element that sits on a rounding boundary of the int8 grid in one
package lands one step over in the other, and AdamW turns that step into
a full update of that element).  The tolerances L2_TOL sit between
those readings and the planted faults (Adafactor on per-layer leaves:
update 0.52; EF-int8 on per-layer leaves under AdamW: 0.052).  The
error-feedback residuals are held by the share of elements that moved
(ERR_SHARE, :func:`moved_share`): an element moved when it differs from
the reference's by more than half its 2048-element block's largest
reference residual, a quarter of the block's int8 step.  Only elements
on a rounding boundary move in a sound run (readings 1.5-1.9e-2); a
residual that is not fed back into the next step's gradient reads
0.58-0.59, one that is never stored 0.52-0.54."""
import dataclasses
import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import DataConfig as JData, SyntheticLM as JSynth  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import OptConfig as JOpt, init_opt as jinit  # noqa: E402
from repro.train import TrainConfig as JTrain  # noqa: E402
from repro.train import compress as jcompress  # noqa: E402
from repro.train import make_train_step as jmake  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.ckpt.checkpoint import flatten_paths  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.optim import OptConfig, init_opt  # noqa: E402
from repro_torch.train import (TrainConfig, compress,  # noqa: E402
                               make_train_step, trainer)

LOSS_RTOL = 1e-5
GNORM_RTOL = {"none": 1e-5, "int8": 1e-4}
L2_TOL = {"none": 1e-4, "int8": 2e-2}
ERR_SHARE = 0.1      # share of residual elements moved a quarter step
BF16_L2 = 5e-2       # bf16 values: the two packages round differently
STEPS = 3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: its tensors are small, and beside
    other test workers a thread pool mostly waits for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def moved_share(got, want, block=compress.BLOCK):
    """Share of the elements of residual ``got`` that differ from the
    reference's ``want`` by more than half the largest |want| of their
    block (a residual lies within half an int8 step of its block)."""
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    pad = (-want.size) % block
    wb = np.pad(want, (0, pad)).reshape(-1, block)
    gb = np.pad(got, (0, pad)).reshape(-1, block)
    half = np.abs(wb).max(axis=1, keepdims=True)
    return float(np.mean((np.abs(gb - wb) > 0.5 * half)
                         .reshape(-1)[:want.size]))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _configs(dtype="float32"):
    over = {} if dtype == "float32" else dict(param_dtype=dtype,
                                              compute_dtype=dtype)
    return (dataclasses.replace(jconfigs.reduced("smollm-135m"), **over),
            dataclasses.replace(tconfigs.reduced("smollm-135m"), **over))


def _data(cfg):
    return JSynth(JData(vocab_size=cfg.vocab_size, seq_len=64,
                        global_batch=4, seed=1))


def _opt(name, **kw):
    return dict(name=name, peak_lr=1e-2, warmup_steps=1, decay_steps=10,
                **kw)


def run_reference(cj, opt, mb, comp, steps=STEPS):
    """-> (per-step metrics, initial numpy params, [(params, opt_state,
    err_state) as numpy trees after each step]); one run per setting
    (the cases share them, read-only)."""
    return _reference(cj, tuple(sorted(opt.items())), mb, comp, steps)


@functools.lru_cache(maxsize=None)
def _reference(cj, opt, mb, comp, steps):
    tcfg = JTrain(microbatch=mb, grad_compression=comp, opt=JOpt(**dict(opt)))
    data = _data(cj)
    params = jlm.init(cj, jax.random.key(2))
    p0 = jax.tree.map(np.asarray, params)
    st = jinit(tcfg.opt, params)
    err = jcompress.init_error_state(params) if comp == "int8" else None
    step_fn = jax.jit(jmake(cj, tcfg))
    metrics, states = [], []
    for s in range(steps):
        batch = {k: jnp.asarray(v) for k, v in data.batch_at(s).items()}
        params, st, err, m = step_fn(params, st, err, batch, jnp.int32(s))
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(jax.tree.map(np.asarray, (params, st, err)))
    return metrics, p0, states


def run_port(ct, p0, opt, mb, comp, steps=range(STEPS), state=None):
    """The port from numpy params p0 (and, to continue a reference run,
    its numpy (params, opt_state, err_state) ``state``)."""
    tcfg = TrainConfig(microbatch=mb, grad_compression=comp,
                       opt=OptConfig(**opt))
    model = convert.params_from_numpy(ct, p0 if state is None else state[0],
                                      "cpu").trainable()
    if state is None:
        params = convert.stacks(model)
        st = init_opt(tcfg.opt, params)
        err = compress.init_error_state(params) if comp == "int8" else None
    else:
        st = convert.opt_state_from_numpy(tcfg.opt, model, state[1])
        err = None if state[2] is None else {
            k: torch.from_numpy(np.array(v)) for k, v in
            flatten_paths(state[2]).items()}
    step_fn = make_train_step(ct, tcfg)
    data = _data(ct)
    metrics = []
    for s in steps:
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(s).items()}
        model, st, err, m = step_fn(model, st, err, batch, s)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, model, st, err


def readings(jm, jstate, p0, tm, model, st, err):
    """The comparison's numbers: worst loss / grad-norm rel error over
    steps, worst rel l2 of a leaf's update, worst rel l2 of a state leaf
    (opt and error feedback; None if the layouts differ)."""
    out = {"loss": max(abs(a["loss"] - b["loss"]) / abs(a["loss"])
                       for a, b in zip(jm, tm)),
           "grad_norm": max(abs(a["grad_norm"] - b["grad_norm"])
                            / a["grad_norm"] for a, b in zip(jm, tm)),
           "lr": max(abs(a["lr"] - b["lr"]) for a, b in zip(jm, tm))}
    jp = flatten_paths(jstate[0])
    z = flatten_paths(p0)
    tp = flatten_paths(convert.tree_to_numpy(model))
    out["update"] = max(_l2(tp[k] - _np(z[k]), _np(jp[k]) - _np(z[k]))
                        for k in jp)
    js, ts = flatten_paths(jstate[1]), flatten_paths(st)
    out["state"] = max(_l2(_np(ts[k]), _np(js[k])) for k in js) \
        if js.keys() == ts.keys() else None
    if err is not None:
        je, te = flatten_paths(jstate[2]), flatten_paths(err)
        out["err"] = max(moved_share(_np(te[k]), _np(je[k])) for k in je) \
            if je.keys() == te.keys() else None
    return out


CASES = list(itertools.product(["adamw", "adafactor"], [0, 2],
                               ["none", "int8"]))


@pytest.mark.parametrize("opt,mb,comp", CASES,
                         ids=[f"{o}-mb{m}-{c}" for o, m, c in CASES])
def test_train_steps_match_reference(opt, mb, comp):
    cj, ct = _configs()
    jm, p0, jstates = run_reference(cj, _opt(opt), mb, comp)
    tm, model, st, err = run_port(ct, p0, _opt(opt), mb, comp)
    r = readings(jm, jstates[-1], p0, tm, model, st, err)
    assert r["loss"] <= LOSS_RTOL and r["lr"] <= 1e-9, r
    assert r["grad_norm"] <= GNORM_RTOL[comp], r
    assert r["update"] <= L2_TOL[comp] and r["state"] <= L2_TOL[comp], r
    assert comp == "none" or r["err"] <= ERR_SHARE, r
    assert int(st["step"]) == STEPS and st["step"].dtype == torch.int32


@pytest.mark.parametrize("opt,comp", [("adamw", "none"),
                                      ("adafactor", "int8")])
def test_continue_a_reference_run(opt, comp):
    """The reference trains steps 0-1; the port takes its parameters,
    optimizer and error-feedback state (opt_state_from_numpy) and runs
    step 2, which must match the reference's step 2."""
    cj, ct = _configs()
    jm, p0, jstates = run_reference(cj, _opt(opt), 2, comp)
    tm, model, st, err = run_port(ct, p0, _opt(opt), 2, comp,
                                  steps=[2], state=jstates[1])
    r = readings(jm[2:], jstates[2], jstates[1][0], tm, model, st, err)
    assert r["loss"] <= LOSS_RTOL and r["grad_norm"] <= GNORM_RTOL[comp], r
    assert r["update"] <= L2_TOL[comp] and r["state"] <= L2_TOL[comp], r
    assert comp == "none" or r["err"] <= ERR_SHARE, r


def _per_layer(real):
    """A planted fault: every stacked leaf split into its layers, as an
    optimizer that works per layer sees them."""
    def leaf_groups(model):
        out = {}
        for path, ps in real(model).items():
            if convert.is_stacked(path):
                for i, p in enumerate(ps):
                    out[f"layer{i}/{path}"] = [p]
            else:
                out[path] = ps
        return out
    return leaf_groups


@pytest.mark.parametrize("opt,comp", [("adafactor", "none"),
                                      ("adamw", "int8")])
def test_per_layer_leaves_are_rejected(opt, comp, monkeypatch):
    """Adafactor's factoring and update clip, and the int8 blocks, see
    the stacked leaf; run per layer they compute something else, and the
    tolerances catch it.  (AdamW without compression is elementwise and
    cannot tell.)"""
    cj, ct = _configs()
    jm, p0, jstates = run_reference(cj, _opt(opt), 0, comp)
    monkeypatch.setattr(convert, "leaf_groups",
                        _per_layer(convert.leaf_groups))
    tm, model, st, err = run_port(ct, p0, _opt(opt), 0, comp)
    monkeypatch.undo()
    r = readings(jm, jstates[-1], p0, tm, model, st, err)
    assert r["update"] > 2 * L2_TOL[comp], r


def _not_fed_back(g, err):
    return _real_quantize(g, torch.zeros_like(err))


def _not_stored(g, err):
    q, scale, _ = _real_quantize(g, err)
    return q, scale, err


_real_quantize = compress.ef_quantize


@pytest.mark.parametrize("fault", [_not_fed_back, _not_stored],
                         ids=["not_fed_back", "not_stored"])
def test_error_feedback_faults_are_rejected(fault, monkeypatch):
    """Planted error-feedback faults: the residual left out of the next
    step's quantization, or never stored.  ERR_SHARE rejects both; the
    updates alone would not always show them."""
    cj, ct = _configs()
    jm, p0, jstates = run_reference(cj, _opt("adamw"), 0, "int8")
    monkeypatch.setattr(compress, "ef_quantize", fault)
    tm, model, st, err = run_port(ct, p0, _opt("adamw"), 0, "int8")
    monkeypatch.undo()
    r = readings(jm, jstates[-1], p0, tm, model, st, err)
    assert r["err"] > 2 * ERR_SHARE, r


def _bf16_share(x):
    """Share of the elements of float32 x that a bfloat16 holds exactly."""
    x = _np(x)
    return float(np.mean(x.astype(ml_dtypes.bfloat16).astype(np.float32)
                         == x))


@pytest.mark.parametrize("planted", [False, True], ids=["sound", "bf16acc"])
def test_microbatch_grads_accumulate_in_float32(planted, monkeypatch):
    """bf16 config, microbatch 2: the reference sums the bf16 microbatch
    gradients into a float32 carry.  With b1 = 0 and no clipping, AdamW's
    mu after one step is that sum exactly, in both packages.  Its values
    agree within BF16_L2 (the packages' bf16 forwards round at different
    places: the gradients differ by 1-2e-2 rel l2, more than a bf16
    rounding of the sum moves them); its precision must too: the share of
    elements a bf16 holds exactly is the reference's within 0.1.
    Accumulating in the parameters' dtype, as .backward() into .grad
    would (planted), makes every element a bf16 and is rejected."""
    cj, ct = _configs("bfloat16")
    opt = _opt("adamw", b1=0.0, clip_norm=1e9)
    jm, p0, jstates = run_reference(cj, opt, 2, "none", steps=1)
    if planted:
        monkeypatch.setattr(trainer, "_accumulate", lambda acc, g, nm: {
            k: acc[k].to(g[k].dtype) + g[k] / nm for k in g})
    tm, model, st, err = run_port(ct, p0, opt, 2, "none", steps=[0])
    jmu = flatten_paths(jstates[0][1]["mu"])
    shares = []
    for k, want in jmu.items():
        assert _l2(_np(st["mu"][k]), want) <= BF16_L2, k
        shares.append((_bf16_share(st["mu"][k]), _bf16_share(want)))
    worst = max(abs(a - b) for a, b in shares)
    assert (worst > 0.1) == planted, shares
