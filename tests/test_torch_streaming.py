"""The l-chunked streaming kernels of the port (repro_torch.kernels.
streaming) and the plan options that reach them (lchunk=, precision=),
against the reference package on identical inputs.

On the CPU the wrappers run the kernels' plain versions; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_streaming.py
does.  Tolerances: the fused tests' (rtol 1e-10 / atol 1e-11 in f64,
5e-4 / 1e-4 in f32) for kernel outputs, rtol 1e-11 for whole transforms
(tests/test_core_soft.py), PRECISION_ERROR_BOUNDS for bf16 against fp32,
BF16_RTOL for bf16 against the Pallas bf16 kernels.
Inside the port, chunked equals monolithic bit for bit.  The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import plan as jplan  # noqa: E402
from repro.core import batched as jb  # noqa: E402
from repro.core import wigner as jwigner  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import streaming as jst  # noqa: E402

from repro_torch import plan as tplan  # noqa: E402
from repro_torch.core import batched as tb  # noqa: E402
from repro_torch.core import soft as tsoft  # noqa: E402
from repro_torch.core import wigner as twigner  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import dwt_fused as tdf  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import streaming as tst  # noqa: E402

JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}
NDT = {torch.float32: np.float32, torch.float64: np.float64}
TK = 4


def _tol(dtype):
    return (5e-4, 1e-4) if dtype == torch.float32 else (1e-10, 1e-11)


def _lchunk(B, lchunk):
    return {"B": B, "B/2": B // 2}.get(lchunk, lchunk)


def _inputs(B, dtype, tk=TK):
    """Identical kernel inputs for both packages, clusters in the
    l-start-sorted order the kernels launch in."""
    jp = jb.build_plan(B, dtype=JDT[dtype], pad_to=tk)
    seeds, m, mp, cb = (np.asarray(x) for x in jops.onthefly_inputs(jp))
    perm, _, l0s = jops.fused_metadata(jp, tk)
    ts, tm, tmp, tcb = tops.onthefly_inputs_from_arrays(
        seeds[perm], m[perm], mp[perm], cb, device="cpu")
    return dict(jp=jp, perm=perm, l0s=l0s,
                jax=(seeds[perm], m[perm], mp[perm], cb),
                torch=(ts, tm, tmp, tcb))


def _jax_windows(inp, dtype, B, lchunk, precision="fp32"):
    seeds, m, mp, cb = inp["jax"]
    dt = JDT[dtype]
    return jst.build_windows(
        jnp.asarray(seeds), jnp.asarray(m, dt)[:, None],
        jnp.asarray(mp, dt)[:, None], jnp.asarray(cb)[None, :], L=B,
        lchunk=lchunk, state_dtype=jnp.bfloat16 if precision == "bf16"
        else dt)


def _operands(inp, B, V, dtype, seed):
    """rhs (K, J, V*16) and lhs (K, B, V*16), lhs zero below each
    cluster's l-start as _gather_coeffs makes it."""
    K, J = inp["jax"][0].shape
    rng = np.random.default_rng(seed)
    rhs = (rng.normal(size=(K, J, V * 16)) * 0.3).astype(NDT[dtype])
    lhs = rng.normal(size=(K, B, V * 16))
    lhs *= (np.arange(B)[None, :] >= inp["jax"][1][:, None])[..., None]
    return rhs, lhs.astype(NDT[dtype])


# ---------------------------------------------------------------------------
# host window oracle and window builder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,lchunk", [(8, 2), (16, 4), (16, 16)])
def test_window_iter_and_table_match_reference(B, lchunk):
    got, pairs = twigner.wigner_window_table(B, lchunk)
    want, jpairs = jwigner.wigner_window_table(B, lchunk)
    np.testing.assert_array_equal(pairs, jpairs)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    chunks = list(twigner.wigner_window_iter(B, lchunk))
    assert len(chunks) == B // lchunk and not chunks[0].any()
    np.testing.assert_array_equal(np.stack(chunks), got)
    with pytest.raises(ValueError, match="divide"):
        next(twigner.wigner_window_iter(B, 3))


@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("lchunk", [1, 2, "B/2", "B"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_build_windows_plain_matches_reference(B, lchunk, dtype):
    lc = _lchunk(B, lchunk)
    inp = _inputs(B, dtype)
    got = tst.build_windows(*inp["torch"], L=B, lchunk=lc)
    assert got.shape == (B // lc, 2) + inp["jax"][0].shape
    assert got.dtype == dtype and not got[0].any()
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(_jax_windows(inp, dtype, B, lc)),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bf16_windows_round_the_fp32_march_once(dtype):
    """bf16 windows are the fp32 march's windows rounded once, on store,
    and agree with the reference's bf16 windows to one bf16 ulp (2**-8
    relative: the two f64 marches may straddle a rounding boundary)."""
    B, lc = 16, 4
    inp = _inputs(B, dtype)
    full = tst.build_windows(*inp["torch"], L=B, lchunk=lc)
    half = tst.build_windows(*inp["torch"], L=B, lchunk=lc,
                             precision="bf16")
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, full.to(torch.bfloat16))
    want = np.asarray(_jax_windows(inp, dtype, B, lc, "bf16"), np.float64)
    np.testing.assert_allclose(half.double().numpy(), want, rtol=2 ** -8,
                               atol=1e-30)


# ---------------------------------------------------------------------------
# the streaming kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("V", [1, 2])
@pytest.mark.parametrize("lchunk", [1, 2, "B/2", "B"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_streaming_matches_reference(B, V, lchunk, dtype):
    lc = _lchunk(B, lchunk)
    inp = _inputs(B, dtype)
    rhs, lhs = _operands(inp, B, V, dtype, seed=B * 100 + V * 10 + lc)
    l0s = inp["l0s"]
    win_t = tst.build_windows(*inp["torch"], L=B, lchunk=lc)
    win_j = _jax_windows(inp, dtype, B, lc)
    rtol, atol = _tol(dtype)
    kw = dict(B=B, tk=TK, lchunk=lc)
    out = tst.dwt_streaming(*inp["torch"], torch.as_tensor(rhs),
                            torch.as_tensor(l0s), win_t, **kw).numpy()
    want = np.asarray(jst.dwt_streaming(*inp["jax"], rhs, l0s, win_j,
                                        interpret=True, **kw))
    np.testing.assert_allclose(out, want, rtol=rtol, atol=atol)
    for g, l0 in enumerate(l0s):      # the ragged skip: exact zeros
        assert not out[g * TK:(g + 1) * TK, :l0].any()
    g = tst.idwt_streaming(*inp["torch"], torch.as_tensor(lhs),
                           torch.as_tensor(l0s), win_t, **kw).numpy()
    want = np.asarray(jst.idwt_streaming(*inp["jax"], lhs, l0s, win_j,
                                         interpret=True, **kw))
    np.testing.assert_allclose(g, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("lchunk", [1, 2, "B/2", "B"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_chunked_equals_monolithic_bitwise(B, lchunk, dtype):
    """fp32 precision: every chunking of the port's plain streaming
    kernels gives the port's plain fused kernels' bits."""
    lc = _lchunk(B, lchunk)
    inp = _inputs(B, dtype)
    rhs, lhs = _operands(inp, B, 2, dtype, seed=lc)
    rhs, lhs = torch.as_tensor(rhs), torch.as_tensor(lhs)
    l0s = torch.as_tensor(inp["l0s"])
    win = tst.build_windows(*inp["torch"], L=B, lchunk=lc)
    kw = dict(B=B, tk=TK)
    assert torch.equal(
        tst.dwt_streaming(*inp["torch"], rhs, l0s, win, lchunk=lc, **kw),
        tdf.dwt_fused(*inp["torch"], rhs, l0s, **kw))
    assert torch.equal(
        tst.idwt_streaming(*inp["torch"], lhs, l0s, win, lchunk=lc, **kw),
        tdf.idwt_fused(*inp["torch"], lhs, l0s, **kw))


# The port's bf16 kernels against the Pallas bf16 kernels, relative to
# max|Pallas|.  Both round each row f32 -> bf16 to nearest even, and the
# windows agree bit for bit, so what is left is the f32 summation order:
# 7.2e-8 to 3.2e-7 on these inputs.  A rounding fault moves a row element
# by one bf16 ulp (2**-8 relative) and the output by ~1e-3 (see
# test_bf16_tolerance_rejects_planted_rounding); chip_smoke.py holds the
# CUDA kernels to their plain versions at the same 1e-5.
BF16_RTOL = 1e-5


def _bf16_case(B):
    dtype, lc = torch.float32, B // 4
    inp = _inputs(B, dtype)
    rhs, lhs = _operands(inp, B, 2, dtype, seed=5)
    win = tst.build_windows(*inp["torch"], L=B, lchunk=lc, precision="bf16")
    win_j = _jax_windows(inp, dtype, B, lc, "bf16")
    assert torch.equal(win.float(), torch.as_tensor(
        np.asarray(win_j).astype(np.float32)))
    kw = dict(B=B, tk=TK, lchunk=lc, precision="bf16")
    cases = []
    for x, bf_fn, fp_fn, j_fn in (
            (rhs, tst.dwt_streaming, tdf.dwt_fused, jst.dwt_streaming),
            (lhs, tst.idwt_streaming, tdf.idwt_fused, jst.idwt_streaming)):
        xt, l0t = torch.as_tensor(x), torch.as_tensor(inp["l0s"])
        pallas = np.asarray(j_fn(*inp["jax"], x, inp["l0s"], win_j,
                                 interpret=True, **kw))
        cases.append((lambda bf_fn=bf_fn, xt=xt, l0t=l0t: bf_fn(
            *inp["torch"], xt, l0t, win, **kw).numpy(),
            fp_fn(*inp["torch"], xt, l0t, B=B, tk=TK).numpy(), pallas))
    return cases


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("B", [8, 16])
def test_bf16_within_error_bound(B):
    """bf16 windows and rows, forward and inverse: against the fp32
    kernels they round, but inside the reference's PRECISION_ERROR_BOUNDS
    gate; against the Pallas bf16 kernels they agree to BF16_RTOL."""
    for run, fp32, pallas in _bf16_case(B):
        got = run()
        assert 0 < _rel(got, fp32) <= autotune.PRECISION_ERROR_BOUNDS[B]
        assert _rel(got, pallas) <= BF16_RTOL


def _rtz_bf16(x):
    """x rounded toward zero to bfloat16 (through float32), in x's dtype."""
    return (x.float().view(torch.int32) & -65536).view(torch.float32) \
        .to(x.dtype)


def _half_rounded():
    """Round rows of every other half of a kLT = 8 staging round only."""
    calls = iter(range(1 << 30))
    return lambda row, precision: (
        row.to(torch.bfloat16).to(row.dtype) if next(calls) % 8 < 4
        else row)


@pytest.mark.parametrize("plant", ["rtz", "unrounded", "half_rounded"])
def test_bf16_tolerance_rejects_planted_rounding(plant, monkeypatch):
    """BF16_RTOL tells a wrong rounding from the right one: with a fault
    planted in the port's row rounding, forward and inverse both miss the
    Pallas bf16 kernels by more than BF16_RTOL."""
    cases = _bf16_case(8)
    rows = {"rtz": lambda row, precision: _rtz_bf16(row),
            "unrounded": lambda row, precision: row,
            "half_rounded": _half_rounded()}[plant]
    monkeypatch.setattr(tst, "_rows", rows)
    for run, _, pallas in cases:
        assert _rel(run(), pallas) > BF16_RTOL


def test_streaming_perm_reads_and_writes_caller_rows():
    """perm= on the plain route: operands in the caller's row order give
    the launch-order result scattered back to those rows."""
    B, lc = 8, 2
    inp = _inputs(B, torch.float64)
    rhs, lhs = _operands(inp, B, 1, torch.float64, seed=3)
    perm = torch.as_tensor(inp["perm"])
    l0s = torch.as_tensor(inp["l0s"])
    win = tst.build_windows(*inp["torch"], L=B, lchunk=lc)
    inv = torch.as_tensor(np.argsort(inp["perm"]))
    for fn, x in ((tst.dwt_streaming, rhs), (tst.idwt_streaming, lhs)):
        sorted_out = fn(*inp["torch"], torch.as_tensor(x), l0s, win, B=B,
                        tk=TK, lchunk=lc)
        caller = torch.as_tensor(x)[inv]          # rows in caller order
        out = fn(*inp["torch"], caller, l0s, win, B=B, tk=TK, lchunk=lc,
                 perm=perm)
        assert torch.equal(out[perm.long()], sorted_out)


# ---------------------------------------------------------------------------
# binding: streaming_inputs, window sources, the wrappers' contracts
# ---------------------------------------------------------------------------

def test_host_window_stack_is_stable_and_matches_device(monkeypatch):
    """The host generator path agrees with the window builder to f64
    roundoff, and a second call returns what the first did: the staging
    buffer is copied, never aliased (torch.from_numpy would alias it)."""
    tp = tb.build_plan(16, pad_to=TK, streaming=True, device="cpu")
    first = tops.host_window_stack(tp, TK, 4)
    second = tops.host_window_stack(tp, TK, 4)
    assert torch.equal(first, second)
    assert first.shape == (4, 2, tp.n_padded, 32)
    monkeypatch.delenv("REPRO_WINDOW_SOURCE", raising=False)
    dev = tops.streaming_inputs(tp, TK, 4, "fp32")[-1]
    np.testing.assert_allclose(first.numpy(), dev.numpy(), atol=1e-12)
    monkeypatch.setenv("REPRO_WINDOW_SOURCE", "host")
    assert tops.window_source() == "host"
    assert torch.equal(tops.streaming_inputs(tp, TK, 4, "fp32")[-1], first)
    half = tops.host_window_stack(tp, TK, 4, "bf16")
    assert torch.equal(half, first.to(torch.bfloat16))
    monkeypatch.setenv("REPRO_WINDOW_SOURCE", "banana")
    with pytest.raises(ValueError, match="REPRO_WINDOW_SOURCE"):
        tops.window_source()


def test_host_window_stack_matches_reference():
    jp = jb.build_plan(16, dtype=jnp.float64, pad_to=TK, streaming=True)
    tp = tb.build_plan(16, pad_to=TK, streaming=True, device="cpu")
    np.testing.assert_allclose(
        tops.host_window_stack(tp, TK, 4).numpy(),
        np.asarray(jops.host_window_stack(jp, TK, 4)), rtol=1e-12,
        atol=1e-14)


def test_streaming_inputs_memoized_per_config(monkeypatch):
    monkeypatch.delenv("REPRO_WINDOW_SOURCE", raising=False)
    tp = tb.build_plan(8, pad_to=8, device="cpu")
    a = tops.streaming_inputs(tp, 8, 2, "fp32")
    assert tops.streaming_inputs(tp, 8, 2, "fp32") is a
    b = tops.streaming_inputs(tp, 8, 2, "bf16")
    assert b is not a and b[-1].dtype == torch.bfloat16
    assert tops.streaming_inputs(tp, 8, 4, "fp32") is not a
    seeds, m, mp, cb, l0s, perm, win = a
    assert perm.dtype == torch.int32 and win.shape == (4, 2, tp.n_padded, 16)


def test_check_lchunk_and_wrapper_contracts():
    assert tst.check_lchunk(16, 4) == 4
    for bad, msg in ((0, "outside"), (17, "outside"), (6, "divide")):
        with pytest.raises(ValueError, match=msg):
            tst.check_lchunk(16, bad)
    inp = _inputs(8, torch.float64)
    l0s = torch.as_tensor(inp["l0s"])
    K, J = inp["jax"][0].shape
    win = tst.build_windows(*inp["torch"], L=8, lchunk=2)
    with pytest.raises(ValueError, match="precision"):
        tst.build_windows(*inp["torch"], L=8, lchunk=2, precision="fp16")
    x = torch.zeros(K, J, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tst.dwt_streaming(*(t.to("meta") for t in inp["torch"]), x[..., 0],
                          l0s.to("meta"), win.to("meta"), B=8, tk=TK,
                          lchunk=2)
    before = dict(tst.LAUNCHES)
    tst.idwt_streaming(*inp["torch"], torch.zeros(K, 8, 16,
                                                   dtype=torch.float64),
                       l0s, win, B=8, tk=TK, lchunk=2)
    assert tst.LAUNCHES == before           # the CPU runs no kernel


@pytest.mark.parametrize("direction", ["dwt", "idwt"])
@pytest.mark.parametrize("kwargs", [dict(lchunk=2),
                                    dict(lchunk=4, precision="fp32")])
def test_make_fn_streaming_matches_reference(direction, kwargs):
    B = 8
    jp = jb.build_plan(B, dtype=jnp.float64, pad_to=8)
    tp = tb.build_plan(B, dtype=torch.float64, pad_to=8, device="cpu")
    A = 2 * B if direction == "dwt" else B
    x = np.random.default_rng(B).normal(size=(2, jp.n_padded, A, 8, 2))
    jfn = getattr(jops, f"make_{direction}_fn")(jp, "fused", tk=8, batch=2,
                                               interpret=True, **kwargs)
    tfn = getattr(tops, f"make_{direction}_fn")(tp, "fused", tk=8, batch=2,
                                               **kwargs)
    fused = getattr(tops, f"make_{direction}_fn")(tp, "fused", tk=8,
                                                 batch=2)
    got = tfn(tp, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jfn(jp, jnp.asarray(x))),
                               rtol=1e-10, atol=1e-11)
    assert torch.equal(got, fused(tp, torch.as_tensor(x)))


# ---------------------------------------------------------------------------
# schedule rules and the planner
# ---------------------------------------------------------------------------

def test_static_precision_never_downgrades_by_default():
    for B in (16, 128, 512):
        assert autotune.static_precision(B) == "fp32"
        assert autotune.static_precision(B, dtype=torch.float32) == "fp32"
    assert autotune.static_precision(8, "bf16") == "bf16"
    assert autotune.static_precision(512, "fp32") == "fp32"
    assert autotune.static_precision(128, "auto",
                                     dtype=torch.float32) == "bf16"
    assert autotune.static_precision(64, "auto",
                                     dtype=torch.float32) == "fp32"
    for B in (128, 512):
        assert autotune.static_precision(B, "auto",
                                         dtype=torch.float64) == "fp32"
    with pytest.raises(ValueError, match="precision"):
        autotune.static_precision(8, "fp16")
    assert autotune.PRECISION_BOUND_EXTRAPOLATED == {256, 512}


def test_static_lchunk_rule():
    # fp32: the monolithic kernels, which fit a block at every B <= 512
    for B in (16, 128, 512):
        for itemsize in (4, 8):
            assert autotune.static_lchunk(B=B, itemsize=itemsize,
                                          precision="fp32") is None
    # bf16 has no monolithic kernel: the largest chunk, B itself
    assert autotune.static_lchunk(B=16, itemsize=4, precision="bf16") == 16
    # past 1024 threads a block no chunk helps: the streaming kernels run
    # the fused kernels' block
    for precision in ("fp32", "bf16"):
        with pytest.raises(ValueError, match="no kernel block fits"):
            autotune.static_lchunk(B=1024, itemsize=8, precision=precision)


def test_window_bytes_enter_the_batch_estimate():
    B, K = 16, 136
    base = autotune.estimate_batch_bytes(B, K, 2, 8)
    assert autotune.window_bytes(B, K, None, "fp32", 8) == 0
    assert autotune.window_bytes(B, K, 4, "fp32", 8) == 4 * 2 * K * 32 * 8
    assert autotune.window_bytes(B, K, 4, "bf16", 8) == 4 * 2 * K * 32 * 2
    assert autotune.estimate_batch_bytes(B, K, 2, 8, lchunk=4) == \
        base + autotune.window_bytes(B, K, 4, "fp32", 8)


@pytest.mark.parametrize("B", [8, 16])
@pytest.mark.parametrize("lchunk", [2, "B/2"])
def test_plan_lchunk_matches_reference_plan(B, lchunk):
    lc = _lchunk(B, lchunk)
    t = tplan(B, device="cpu", V=2, lchunk=lc)
    j = jplan(B, V=2, lchunk=lc)
    assert t.schedule.lchunk == lc and t.schedule.precision == "fp32"
    fhats = np.stack([tsoft.random_coeffs(B, s) for s in range(3)])
    fs = t.inverse_batch(fhats)
    np.testing.assert_allclose(fs.numpy(), np.asarray(j.inverse_batch(fhats)),
                               rtol=1e-11, atol=1e-12)
    backs = t.forward_batch(fs)
    np.testing.assert_allclose(
        backs.numpy(), np.asarray(j.forward_batch(jnp.asarray(fs.numpy()))),
        rtol=1e-11, atol=1e-12)
    # inside the port the chunked plan gives the monolithic plan's bits
    mono = tplan(B, device="cpu", V=2)
    assert torch.equal(fs, mono.inverse_batch(fhats))
    assert torch.equal(backs, mono.forward_batch(fs))
    assert torch.equal(t.inverse(fhats[0]), mono.inverse(fhats[0]))


def test_plan_bf16_within_error_bound():
    B = 16
    bound = autotune.PRECISION_ERROR_BOUNDS[B]
    t = tplan(B, torch.float32, device="cpu", V=2, precision="bf16")
    s = t.schedule
    assert s.precision == "bf16" and s.lchunk == B    # always streams
    assert s.window_bytes == autotune.window_bytes(B, t.soft_plan.n_padded,
                                                   B, "bf16", 4)
    mono = tplan(B, torch.float32, device="cpu", V=2)
    fhat = tsoft.random_coeffs(B, 5).astype(np.complex64)
    f32, f16 = mono.inverse(fhat), t.inverse(fhat)
    rel = float((f16 - f32).abs().max() / f32.abs().max())
    assert 0 < rel <= bound
    b32, b16 = mono.forward(f32), t.forward(f32)
    rel = float((b16 - b32).abs().max() / b32.abs().max())
    assert 0 < rel <= bound
    # precision="auto" keeps a small float32 plan, and any float64 plan,
    # on fp32
    assert tplan(B, torch.float32, device="cpu", precision="auto") \
        .schedule.precision == "fp32"


def test_plan_keys_and_describe_streaming_fields():
    tplan.clear_cache()
    a = tplan(8, device="cpu", V=2)
    b = tplan(8, device="cpu", V=2, lchunk=2)
    c = tplan(8, device="cpu", V=2, lchunk=2, precision="fp32")
    assert a is not b and b is c and a.schedule.lchunk is None
    d = b.describe()
    assert d["lchunk"] == 2 and d["precision"] == "fp32"
    assert d["window_bytes"] == 4 * 2 * a.soft_plan.n_padded * 16 * 8
    assert d["batch_bytes"] == a.describe()["batch_bytes"] + d["window_bytes"]
    assert not d["precision_bound_extrapolated"]
    assert set(d["kernel_launches"]) == {
        "dwt_fused", "idwt_fused", "build_windows", "dwt_streaming",
        "idwt_streaming", "dwt_onthefly", "idwt_onthefly", "dwt_dense",
        "idwt_dense", "dwt_ragged"}


@pytest.mark.parametrize("kwargs, msg", [
    (dict(lchunk=3), "divide"),
    (dict(lchunk=0), "outside"),
    (dict(precision="fp16"), "precision"),
    (dict(precision="bf16", dtype=torch.float64, lchunk=5), "divide"),
    (dict(impl="reference", lchunk=2), "impl='fused'"),
    (dict(impl="reference", precision="bf16"), "impl='fused'"),
])
def test_plan_rejects_bad_streaming_options(kwargs, msg):
    with pytest.raises(ValueError, match=msg):
        tplan(8, device="cpu", **kwargs)
