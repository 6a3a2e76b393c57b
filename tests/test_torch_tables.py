"""Host tables of the port (repro_torch.core) against the reference
package: index maps, clusters, quadrature, Wigner seeds and tables, the
plan arrays (dense and streaming) and the fused kernels' inputs and
schedule.  Everything here is exact: the port keeps its own copies of
the numpy code, so the tables must be array-equal."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import batched as jb  # noqa: E402
from repro.core import clusters as jclusters  # noqa: E402
from repro.core import indexing as jindexing  # noqa: E402
from repro.core import quadrature as jquad  # noqa: E402
from repro.core import soft as jsoft  # noqa: E402
from repro.core import wigner as jwigner  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch.core import batched as tb  # noqa: E402
from repro_torch.core import clusters as tclusters  # noqa: E402
from repro_torch.core import indexing as tindexing  # noqa: E402
from repro_torch.core import quadrature as tquad  # noqa: E402
from repro_torch.core import soft as tsoft  # noqa: E402
from repro_torch.core import wigner as twigner  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

BANDWIDTHS = [4, 8, 16, 32]
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("B", BANDWIDTHS)
def test_index_maps_equal(B):
    K = tindexing.kappa_domain_size(B)
    assert K == jindexing.kappa_domain_size(B)
    kap = np.arange(K)
    for a, b in zip(tindexing.kappa_to_mm(kap, B), jindexing.kappa_to_mm(kap, B)):
        np.testing.assert_array_equal(a, b)
    pairs = tindexing.regular_pairs(B)
    np.testing.assert_array_equal(pairs, jindexing.regular_pairs(B))
    np.testing.assert_array_equal(
        tindexing.mm_to_kappa(pairs[:, 0], pairs[:, 1], B),
        jindexing.mm_to_kappa(pairs[:, 0], pairs[:, 1], B))
    sig = np.arange(B * (B + 1) // 2)
    for a, b in zip(tindexing.sigma_to_mm(sig), jindexing.sigma_to_mm(sig)):
        np.testing.assert_array_equal(a, b)
    work = np.random.default_rng(B).integers(1, B, size=K)
    np.testing.assert_array_equal(tindexing.balanced_order(work, 4),
                                  jindexing.balanced_order(work, 4))


@pytest.mark.parametrize("B", BANDWIDTHS)
def test_quadrature_equal(B):
    for name in ("alphas", "betas", "gammas", "weights"):
        np.testing.assert_array_equal(getattr(tquad, name)(B),
                                      getattr(jquad, name)(B))
    assert tquad.grid_shape(B) == jquad.grid_shape(B)


@pytest.mark.parametrize("B", BANDWIDTHS)
def test_cluster_table_equal(B):
    a = tclusters.build_cluster_table(B)
    b = jclusters.build_cluster_table(B)
    for f in dataclasses.fields(b):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name),
                                      err_msg=f.name)
    np.testing.assert_array_equal(a.work(), b.work())
    np.testing.assert_array_equal(a.l_start(), b.l_start())


@pytest.mark.parametrize("B", BANDWIDTHS)
def test_wigner_seeds_and_tables_equal(B):
    beta = jquad.betas(B)
    for m, mp in jwigner.fundamental_pairs(B)[:: max(1, B // 3)]:
        np.testing.assert_array_equal(twigner.wigner_seed(int(m), int(mp), beta),
                                      jwigner.wigner_seed(int(m), int(mp), beta))
    np.testing.assert_array_equal(twigner.fundamental_pairs(B),
                                  jwigner.fundamental_pairs(B))
    ta, _ = twigner.wigner_d_fundamental(B)
    ja, _ = jwigner.wigner_d_fundamental(B)
    np.testing.assert_array_equal(ta, ja)
    l = np.arange(B)[:, None]
    for a, b in zip(twigner.recurrence_coeffs(l, 3, 1),
                    jwigner.recurrence_coeffs(l, 3, 1)):
        np.testing.assert_array_equal(a, b)
    if B <= 16:
        np.testing.assert_array_equal(twigner.wigner_d_table(B),
                                      jwigner.wigner_d_table(B))
        np.testing.assert_array_equal(
            twigner.wigner_d_explicit(B - 1, 1, 2, beta),
            jwigner.wigner_d_explicit(B - 1, 1, 2, beta))


def _jax_arrays(p):
    arrays = {n: (None if getattr(p, n) is None else np.asarray(getattr(p, n)))
              for n in jb._PLAN_LEAVES}
    arrays["table"] = dataclasses.asdict(p.table)
    return arrays


def _assert_plans_equal(tp, jp):
    assert tp.B == jp.B and tp.n_padded == jp.n_padded
    assert tp.streaming == jp.streaming
    for n in tb.PLAN_LEAVES:
        a, b = getattr(tp, n), getattr(jp, n)
        if b is None:
            assert a is None, n
            continue
        np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=n)
    for f in dataclasses.fields(jp.table):
        np.testing.assert_array_equal(getattr(tp.table, f.name),
                                      getattr(jp.table, f.name), err_msg=f.name)


@pytest.mark.parametrize("B", BANDWIDTHS)
@pytest.mark.parametrize("streaming", [False, True])
def test_build_plan_arrays_equal(B, streaming):
    tp = tb.build_plan(B, dtype=torch.float64, pad_to=8, streaming=streaming,
                       device="cpu")
    jp = jb.build_plan(B, dtype=jnp.float64, pad_to=8, streaming=streaming)
    _assert_plans_equal(tp, jp)
    assert tp.device == torch.device("cpu")
    assert tp.dtype == torch.float64
    assert tb.build_plan(B, dtype=torch.float64, pad_to=8,
                         streaming=streaming, device="cpu") is tp   # memoized


@pytest.mark.parametrize("B", [4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("streaming", [False, True])
def test_soft_plan_from_arrays_matches_own_plan(B, dtype, streaming):
    jp = jb.build_plan(B, dtype=JDT[dtype], pad_to=8, streaming=streaming)
    ported = tb.soft_plan_from_arrays(B, _jax_arrays(jp),
                                      n_padded=jp.n_padded, plan_dtype=dtype,
                                      device="cpu")
    own = tb.build_plan(B, dtype=dtype, pad_to=8, streaming=streaming,
                        device="cpu")
    _assert_plans_equal(ported, jp)
    for n in tb.PLAN_LEAVES:
        a, b = getattr(ported, n), getattr(own, n)
        assert (a is None) == (b is None), n
        if a is not None:
            assert a.dtype == b.dtype, n
            assert torch.equal(a, b), n


@pytest.mark.parametrize("B", [4, 8, 16])
@pytest.mark.parametrize("tk", [4, 8])
def test_fused_inputs_and_schedule_equal(B, tk):
    tp = tb.build_plan(B, pad_to=8, streaming=True, device="cpu")
    jp = jb.build_plan(B, dtype=jnp.float64, pad_to=8, streaming=True)
    for a, b in zip(tops.onthefly_inputs(tp), jops.onthefly_inputs(jp)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    for a, b in zip(tops.fused_metadata(tp, tk), jops.fused_metadata(jp, tk)):
        np.testing.assert_array_equal(a, b)
    ins = tops.onthefly_inputs_from_arrays(
        *[np.asarray(x) for x in jops.onthefly_inputs(jp)], device="cpu")
    for a, b in zip(ins, tops.onthefly_inputs(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("B", [4, 8])
def test_soft_numpy_parts_equal(B):
    np.testing.assert_array_equal(tsoft.coeff_mask(B), jsoft.coeff_mask(B))
    assert tsoft.coeff_count(B) == jsoft.coeff_count(B)
    fhat = tsoft.random_coeffs(B, 3)
    np.testing.assert_array_equal(fhat, jsoft.random_coeffs(B, 3))
    f = tsoft.direct_inverse(fhat)
    np.testing.assert_array_equal(f, jsoft.direct_inverse(fhat))
    np.testing.assert_array_equal(tsoft.direct_forward(f, B),
                                  jsoft.direct_forward(f, B))


@pytest.mark.parametrize("B", [4, 8])
def test_separated_soft_matches_reference(B):
    fhat = tsoft.random_coeffs(B, 4)
    f = tsoft.inverse_soft(torch.as_tensor(fhat))
    np.testing.assert_allclose(f.numpy(), np.asarray(jsoft.inverse_soft(fhat)),
                               rtol=1e-11, atol=1e-12)
    back = tsoft.forward_soft(f, B)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jsoft.forward_soft(f.numpy(), B)),
        rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(back.numpy(), fhat, rtol=1e-11, atol=1e-12)
