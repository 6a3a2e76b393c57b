"""The fused DWT / iDWT of the port (repro_torch.kernels) against the
reference package on identical inputs.

On the CPU the wrappers run the kernels' plain versions; the JAX side
runs its Pallas kernels in interpret mode, as the reference's own tests
do.  Tolerances are the reference's (tests/test_dwt_fused.py): rtol
1e-10 / atol 1e-11 in f64, 5e-4 / 1e-4 in f32.  The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import batched as jb  # noqa: E402
from repro.kernels import dwt_fused as jdf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.wigner_rec import _recurrence_step  # noqa: E402

from repro_torch.core import batched as tb  # noqa: E402
from repro_torch.kernels import dwt_fused as tdf  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.wigner_rec import recurrence_step  # noqa: E402

JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}
NDT = {torch.float32: np.float32, torch.float64: np.float64}


def _tol(dtype):
    return (5e-4, 1e-4) if dtype == torch.float32 else (1e-10, 1e-11)


def _inputs(B, dtype, tk=4):
    """Identical fused-kernel inputs for both packages, clusters in the
    l-start-sorted order the kernels launch in."""
    jp = jb.build_plan(B, dtype=JDT[dtype], pad_to=tk)
    seeds, m, mp, cb = (np.asarray(x) for x in jops.onthefly_inputs(jp))
    perm, _, l0s = jops.fused_metadata(jp, tk)
    ts, tm, tmp, tcb = tops.onthefly_inputs_from_arrays(
        seeds[perm], m[perm], mp[perm], cb, device="cpu")
    return dict(jp=jp, perm=perm, l0s=l0s,
                jax=(seeds[perm], m[perm], mp[perm], cb),
                torch=(ts, tm, tmp, tcb))


@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("V", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_forward_matches_reference(B, V, dtype):
    tk = 4
    inp = _inputs(B, dtype, tk)
    K, J = inp["jax"][0].shape
    rng = np.random.default_rng(B * 10 + V)
    rhs = (rng.normal(size=(K, J, V * 16)) * 0.3).astype(NDT[dtype])
    l0s = inp["l0s"]
    out = tdf.dwt_fused(*inp["torch"], torch.as_tensor(rhs),
                        torch.as_tensor(l0s), B=B, tk=tk).numpy()
    expect = np.asarray(jdf.dwt_fused(*inp["jax"], rhs, l0s, B=B, tk=tk,
                                      interpret=True))
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(out, expect, rtol=rtol, atol=atol)
    d = np.asarray(inp["jp"].d)[inp["perm"]]
    np.testing.assert_allclose(out, np.asarray(jref.dwt_ref(d, rhs)),
                               rtol=rtol, atol=atol)
    for g, l0 in enumerate(l0s):      # the ragged skip: exact zeros
        assert not out[g * tk:(g + 1) * tk, :l0].any()


@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("V", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_inverse_matches_reference(B, V, dtype):
    tk = 4
    inp = _inputs(B, dtype, tk)
    jp = inp["jp"]
    rng = np.random.default_rng(B * 10 + V + 1)
    # lhs as _gather_coeffs makes it: zero below each cluster's l-start
    fh = [rng.uniform(-1, 1, (B, 2 * B - 1, 2 * B - 1)) for _ in range(V)]
    lhs = np.asarray(jops.pack_lanes(
        jnp.stack([jb._gather_coeffs(jp, jnp.asarray(f)) for f in fh])))
    lhs = lhs[inp["perm"]].astype(NDT[dtype])
    l0s = inp["l0s"]
    out = tdf.idwt_fused(*inp["torch"], torch.as_tensor(lhs),
                         torch.as_tensor(l0s), B=B, tk=tk).numpy()
    expect = np.asarray(jdf.idwt_fused(*inp["jax"], lhs, l0s, B=B, tk=tk,
                                       interpret=True))
    rtol, atol = _tol(dtype)
    np.testing.assert_allclose(out, expect, rtol=rtol, atol=atol)
    d = np.asarray(jp.d)[inp["perm"]]
    np.testing.assert_allclose(out, np.asarray(jref.idwt_ref(d, lhs)),
                               rtol=rtol, atol=atol)


def test_unseeded_cluster_is_zero():
    """A cluster whose m lies below its tile's l0 is never seeded, as in
    the TPU kernel, which starts the tile's march at l0."""
    B, tk = 8, 4
    inp = _inputs(B, torch.float64, tk)
    l0s = inp["l0s"].copy()
    l0s[0] = 3                       # tile 0 holds m = 0..1 clusters
    K, J = inp["jax"][0].shape
    rhs = np.random.default_rng(0).normal(size=(K, J, 16))
    out = tdf.dwt_fused(*inp["torch"], torch.as_tensor(rhs),
                        torch.as_tensor(l0s), B=B, tk=tk).numpy()
    expect = np.asarray(jdf.dwt_fused(*inp["jax"], rhs, l0s, B=B, tk=tk,
                                      interpret=True))
    np.testing.assert_allclose(out, expect, rtol=1e-10, atol=1e-11)
    assert not out[:tk].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_recurrence_step_matches_reference(dtype):
    B = 16
    inp = _inputs(B, dtype, 4)
    seeds, m, mp, cb = inp["jax"]
    ts, tm, tmp, tcb = inp["torch"]
    mf, mpf = tm.to(dtype)[:, None], tmp.to(dtype)[:, None]
    jm = jnp.asarray(m.astype(NDT[dtype]))[:, None]
    jmp = jnp.asarray(mp.astype(NDT[dtype]))[:, None]
    tstate = [torch.zeros_like(ts)] * 2
    jstate = [jnp.zeros(seeds.shape, JDT[dtype])] * 2
    rtol, atol = _tol(dtype)
    for l in range(B):
        trow, *tstate = recurrence_step(l, mf, mpf, tcb[None, :], *tstate, ts)
        jrow, *jstate = _recurrence_step(jnp.asarray(l), jm, jmp,
                                         jnp.asarray(cb)[None, :], *jstate,
                                         jnp.asarray(seeds))
        np.testing.assert_allclose(trow.numpy(), np.asarray(jrow), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("B", [4, 8, 16])
def test_wigner_table_ref_matches_reference(B):
    inp = _inputs(B, torch.float64, 4)
    ts, tm, tmp, tcb = inp["torch"]
    got = tref.wigner_rec_table_ref(ts, tm, tmp, tcb, B).numpy()
    want = np.asarray(jref.wigner_rec_table_ref(*map(jnp.asarray, inp["jax"]),
                                                B))
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(inp["jp"].d)[inp["perm"]],
                               rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("B", [4, 8])
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("direction", ["dwt", "idwt"])
def test_make_fn_matches_reference(B, batch, direction):
    jp = jb.build_plan(B, dtype=jnp.float64, pad_to=8)
    tp = tb.build_plan(B, dtype=torch.float64, pad_to=8, device="cpu")
    A = 2 * B if direction == "dwt" else B
    lead = () if batch is None else (batch,)
    x = np.random.default_rng(B).normal(size=lead + (jp.n_padded, A, 8, 2))
    jfn = getattr(jops, f"make_{direction}_fn")(jp, "fused", tk=8,
                                               batch=batch, interpret=True)
    tfn = getattr(tops, f"make_{direction}_fn")(tp, "fused", tk=8,
                                               batch=batch)
    np.testing.assert_allclose(tfn(tp, torch.as_tensor(x)).numpy(),
                               np.asarray(jfn(jp, jnp.asarray(x))),
                               rtol=1e-10, atol=1e-11)


def test_cpu_wrappers_launch_no_kernel():
    inp = _inputs(8, torch.float64, 4)
    K, J = inp["jax"][0].shape
    before = dict(tdf.LAUNCHES)
    tdf.dwt_fused(*inp["torch"], torch.zeros(K, J, 16, dtype=torch.float64),
                  torch.as_tensor(inp["l0s"]), B=8, tk=4)
    tdf.idwt_fused(*inp["torch"], torch.zeros(K, 8, 16, dtype=torch.float64),
                   torch.as_tensor(inp["l0s"]), B=8, tk=4)
    assert tdf.LAUNCHES == before


def test_lane_packing_roundtrip():
    x = torch.randn(3, 5, 7, 8, 2, dtype=torch.float64)
    packed = tops.pack_lanes(x)
    assert packed.shape == (5, 7, 48)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jops.pack_lanes(x.numpy())))
    assert torch.equal(tops.unpack_lanes(packed, 3, 8), x)
    padded, n = tops.pad_lanes(x[:2], 4)
    assert n == 2 and padded.shape == (4, 5, 7, 8, 2)
    assert torch.equal(padded[:2], x[:2]) and not padded[2:].any()
    with pytest.raises(ValueError, match="exceeds lane width"):
        tops.pad_lanes(x, 2)


@pytest.mark.parametrize("impl", ["dense", "ragged", "onthefly"])
def test_other_schedules_match_fused(impl):
    """make_dwt_fn / make_idwt_fn of the schedules ported after the fused
    one give the fused fns' results: bit for bit for onthefly, within
    the reference's f64 tolerance for the table schedules (ragged runs
    its inverse on dense, and has no inverse fn of its own)."""
    tp = tb.build_plan(8, pad_to=8, device="cpu")
    rng = np.random.default_rng(5)
    for direction, A in (("dwt", 16), ("idwt", 8)):
        x = torch.as_tensor(rng.normal(size=(tp.n_padded, A, 8, 2)))
        maker = getattr(tops, f"make_{direction}_fn")
        want = maker(tp)(tp, x)
        if impl == "ragged" and direction == "idwt":
            with pytest.raises(ValueError, match="no inverse kernel"):
                maker(tp, impl, tl=4)
            continue
        got = maker(tp, impl, tl=4)(tp, x)
        if impl == "onthefly":
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-10, atol=1e-11)


@pytest.mark.parametrize("kwargs", [dict(lchunk=4), dict(precision="bf16")])
def test_streaming_schedules_run(kwargs):
    """lchunk / precision="bf16" build the streaming kernels' fns; fp32
    chunking gives the fused fns' bits, bf16 stays near them."""
    tp = tb.build_plan(8, pad_to=8, device="cpu")
    rng = np.random.default_rng(4)
    for direction, A in (("dwt", 16), ("idwt", 8)):
        x = torch.as_tensor(rng.normal(size=(tp.n_padded, A, 8, 2)))
        got = getattr(tops, f"make_{direction}_fn")(tp, **kwargs)(tp, x)
        want = getattr(tops, f"make_{direction}_fn")(tp)(tp, x)
        if "lchunk" in kwargs:
            assert torch.equal(got, want)
        else:
            rel = float((got - want).abs().max() / want.abs().max())
            assert 0 < rel <= 1.2e-2     # PRECISION_ERROR_BOUNDS[8]


def test_perm_reads_and_writes_caller_rows():
    """perm= on the plain route: operands in the caller's row order give
    the launch-order result scattered back to those rows."""
    B = 8
    inp = _inputs(B, torch.float64, 4)
    perm = torch.as_tensor(inp["perm"])
    inv = torch.as_tensor(np.argsort(inp["perm"]))
    l0s = torch.as_tensor(inp["l0s"])
    K, J = inp["jax"][0].shape
    rng = np.random.default_rng(2)
    for fn, A in ((tdf.dwt_fused, J), (tdf.idwt_fused, B)):
        x = torch.as_tensor(rng.normal(size=(K, A, 16)))
        sorted_out = fn(*inp["torch"], x, l0s, B=B, tk=4)
        out = fn(*inp["torch"], x[inv], l0s, B=B, tk=4, perm=perm)
        assert torch.equal(out[perm.long()], sorted_out)


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.zeros(8, 16, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tdf.dwt_fused(x[:, :, 0], x[:, 0, 0].int(), x[:, 0, 0].int(),
                      x[0, :, 0], x, x[:2, 0, 0].int(), B=8, tk=4)


def test_launch_errors_raise():
    from repro_torch.kernels import runtime
    runtime.check_launch(0, "ok")
    with pytest.raises(RuntimeError, match="cudaError_t 98"):
        runtime.check_launch(98, "dwt_fused")
