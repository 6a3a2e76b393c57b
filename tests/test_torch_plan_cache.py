"""The port's build_plan memo against the reference's: a byte-bounded LRU
($REPRO_PLAN_CACHE_BYTES, default 2 GiB) with the same hits, misses,
evictions and plan count for the same calls
(tests/test_plan.py::test_soft_plan_cache_byte_bound_and_stats on the
reference).  The two packages lay their plans out differently (the
reference's index tables are int32 under JAX's defaults, the port's
int64), so each package's byte total is its own: the port's is the sum
of its held plans' tensor bytes."""
import collections

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import plan as jplan  # noqa: E402
from repro.core import batched as jb  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch.core import batched as tb  # noqa: E402

STATS = ("hits", "misses", "evictions", "plans")


def _private_memo(monkeypatch, mod):
    monkeypatch.setattr(mod, "_PLAN_CACHE", collections.OrderedDict())
    monkeypatch.setattr(mod, "_PLAN_CACHE_STATS",
                        {"hits": 0, "misses": 0, "evictions": 0})


def _tensor_bytes(plan) -> int:
    return sum(t.numel() * t.element_size()
               for t in (getattr(plan, n) for n in tb.PLAN_LEAVES)
               if t is not None)


# (B, streaming) builds in order; the limit holds about `plans` B = 8
# dense plans of the package's own layout
SEQUENCES = {
    "evict_lru": ([(8, False), (8, False), (12, False), (8, False),
                   (8, True), (12, False), (4, False), (8, True)], 1.5),
    "dense_sweep": ([(4, False), (8, False), (12, False), (4, False),
                     (16, False), (8, False), (12, False)], 2.5),
    "one_over_budget": ([(16, False), (8, False), (16, False), (4, True)],
                        0.5),
    "default_limit": ([(4, False), (8, False), (4, False), (8, True)], None),
}


def _run(monkeypatch, mod, build, seq, plans):
    _private_memo(monkeypatch, mod)
    monkeypatch.delenv("REPRO_PLAN_CACHE_BYTES", raising=False)
    one = None
    if plans is not None:
        build(8, False)
        one = mod.plan_cache_stats()["bytes"]
        _private_memo(monkeypatch, mod)
        monkeypatch.setenv("REPRO_PLAN_CACHE_BYTES", str(int(one * plans)))
    trace = []
    for B, streaming in seq:
        build(B, streaming)
        st = mod.plan_cache_stats()
        trace.append(tuple(st[k] for k in STATS))
    return trace, mod.plan_cache_stats()


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_plan_memo_matches_reference(monkeypatch, name):
    seq, plans = SEQUENCES[name]
    ref, _ = _run(monkeypatch, jb, lambda B, s: jb.build_plan(
        B, dtype=jnp.float64, streaming=s), seq, plans)
    got, st = _run(monkeypatch, tb, lambda B, s: tb.build_plan(
        B, dtype=torch.float64, streaming=s, device="cpu"), seq, plans)
    assert got == ref
    assert st["bytes"] == sum(_tensor_bytes(p)
                              for p, _ in tb._PLAN_CACHE.values())
    assert st["bytes_limit"] == tb.plan_cache_bytes_limit()
    if plans is not None:
        assert ref[-1][2] > 0          # the sequence does evict


def test_plan_memo_byte_bound_and_stats(monkeypatch):
    """test_plan.py's byte-bound walk, on the port."""
    _private_memo(monkeypatch, tb)
    monkeypatch.delenv("REPRO_PLAN_CACHE_BYTES", raising=False)
    st = tb.plan_cache_stats()
    assert set(st) == {"hits", "misses", "evictions", "plans", "bytes",
                       "bytes_limit"}
    assert st["plans"] == 0 and st["bytes"] == 0
    assert st["bytes_limit"] == tb._PLAN_CACHE_DEFAULT_BYTES == 2 * 1024 ** 3

    a = tb.build_plan(8, device="cpu")
    assert a is tb.build_plan(8, device="cpu")                  # hit
    st = tb.plan_cache_stats()
    assert (st["hits"], st["misses"], st["plans"]) == (1, 1, 1)
    one = st["bytes"]
    assert one == _tensor_bytes(a) > 0

    monkeypatch.setenv("REPRO_PLAN_CACHE_BYTES", str(one * 3 // 2))
    assert tb.plan_cache_stats()["bytes_limit"] == one * 3 // 2
    tb.build_plan(12, device="cpu")
    st = tb.plan_cache_stats()
    assert st["evictions"] == 1 and st["plans"] == 1     # B = 8 dropped
    b = tb.build_plan(8, device="cpu")
    assert b is not a                                    # rebuilt
    assert len(tb._PLAN_CACHE) >= 1       # the newest always stays
    tb.build_plan(8, device="cpu", streaming=True)
    key = (8, torch.float64, None, None, True, "cpu")
    assert tb._PLAN_CACHE[key][1] < one   # no table: far smaller
    tb.clear_plan_cache()
    assert tb.plan_cache_stats() == dict(
        hits=0, misses=0, evictions=0, plans=0, bytes=0,
        bytes_limit=one * 3 // 2)


def test_cache_stats_surfaces_the_memo():
    """plan.cache_stats()["soft_plan_cache"] carries the reference's
    keys."""
    tplan(4, device="cpu")
    assert set(jplan.cache_stats()["soft_plan_cache"]) == \
        set(tplan.cache_stats()["soft_plan_cache"])
