"""The measured half of repro_torch.kernels.autotune on the CPU: the
candidate tiles against the reference's, the cache key's grammar (the
card's backend segment included), the atomic cache merge, the sweep on
the kernels' plain versions (B = 4..8, one timed call a candidate), its
hit / miss / failure counters and spans, plan(tune="measure") within
rtol 1e-11 / atol 1e-12 of repro.plan(B), and the profile_so3 --check
trace at B = 8."""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import plan as jplan  # noqa: E402
from repro.kernels import autotune as jtune  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch import plan as tplan  # noqa: E402
from repro_torch.core import batched as tb  # noqa: E402
from repro_torch.core import soft as tsoft  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import profile_so3  # noqa: E402

RTOL, ATOL = 1e-11, 1e-12


@pytest.fixture
def rec():
    r = obs.Recorder()
    old = obs.set_recorder(r)
    try:
        yield r
    finally:
        obs.set_recorder(old)


@pytest.mark.parametrize("K, L", [(40, 8), (136, 16), (9, 8), (18, 8)])
@pytest.mark.parametrize("impl", ["fused", "onthefly"])
def test_recurrence_candidates_match_reference(K, L, impl):
    assert autotune.candidate_tiles(K, L, 2 * L, impl) == \
        jtune.candidate_tiles(K, L, 2 * L, impl)


@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_table_candidates_have_no_beta_tile(impl):
    """The port's table kernels have no beta tile (tj = J), and only the
    ragged work list has a degree tile: the reference's (tk, tl) pairs
    at tj = J for ragged, its tk at tl = L for dense."""
    K, L, J = 136, 16, 32
    ref = [c for c in jtune.candidate_tiles(K, L, J, impl) if c["tj"] == J]
    if impl == "dense":
        ref = [c for c in ref if c["tl"] == L]
    assert autotune.candidate_tiles(K, L, J, impl) == ref


def test_key_grammar_names_backend_and_budgets(monkeypatch):
    p = tb.build_plan(8, pad_to=8, device="cpu")
    key = autotune._key(p, "fused", (1, 2), n_shards=2, overlap="pipelined",
                        lchunk=4, precision="bf16")
    budget = autotune.memory_budget_bytes(p.device)
    assert key == (f"fused/B8/K40/float64/cpu/V(1, 2)/"
                   f"M{autotune.SMEM_LIMIT_BYTES}-{budget}/S2/Opipelined/"
                   f"L4/Pbf16")
    assert autotune._key(p, "onthefly", 1).endswith("/S1/Ooff/L0/Pfp32")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda d=None: (9, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert autotune.backend_name(torch.device("cuda", 0)) == \
        "cuda-sm90-NVIDIA_H100_80GB_HBM3"
    assert autotune.backend_name(torch.device("cpu")) == "cpu"


def test_cache_merge_keeps_every_key(tmp_path, monkeypatch):
    path = tmp_path / "sub" / "tune.json"
    autotune._store_cache(path, {"a": {"V": 1}})
    autotune._store_cache(path, {"b": {"V": 2}})
    autotune._store_cache(path, {"a": {"V": 4}})
    assert json.loads(path.read_text()) == {"a": {"V": 4}, "b": {"V": 2}}
    assert [q.name for q in path.parent.iterdir()] == ["tune.json"]
    path.write_text("{not json")
    assert autotune._load_cache(path) == {}
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "x.json"))
    assert autotune.cache_path() == tmp_path / "x.json"


@pytest.mark.parametrize("B, impl", [(4, "fused"), (8, "fused"),
                                     (8, "onthefly"), (8, "dense"),
                                     (8, "ragged")])
def test_autotune_dwt_sweeps_plain_versions(tmp_path, rec, B, impl):
    p = tb.build_plan(B, pad_to=8, device="cpu")
    cache = tmp_path / "tune.json"
    cfg = autotune.autotune_dwt(p, impl, Vs=(1, 2), reps=1, cache=cache)
    assert set(cfg) == {"tk", "tl", "tj", "V", "per_transform_s"}
    assert cfg["V"] in (1, 2) and cfg["per_transform_s"] > 0
    assert p.n_padded % cfg["tk"] == 0 and cfg["tj"] == 2 * B
    cands = autotune.candidate_tiles(p.n_padded, B, 2 * B, impl)
    spans = [e for e in rec.events() if e["name"] == "autotune.candidate"]
    assert len(spans) == 2 * len(cands)
    assert all(e["args"]["clock"] == "host" for e in spans)
    assert rec.counter("autotune.cache.miss") == 1
    again = autotune.autotune_dwt(p, impl, Vs=(1, 2), reps=1, cache=cache)
    assert again == cfg and rec.counter("autotune.cache.hit") == 1
    assert len([e for e in rec.events()
                if e["name"] == "autotune.candidate"]) == len(spans)


def test_autotune_skips_over_budget_and_counts_failures(tmp_path, rec,
                                                        monkeypatch):
    p = tb.build_plan(8, pad_to=8, device="cpu")
    orig = tops.make_dwt_fn

    def flaky(plan, impl, *, tk, **kw):
        if tk == 4:
            raise RuntimeError("tile rejected")
        return orig(plan, impl, tk=tk, **kw)

    monkeypatch.setattr(tops, "make_dwt_fn", flaky)
    cfg = autotune.autotune_dwt(p, "fused", reps=1, cache=tmp_path / "a")
    assert cfg["tk"] == 8
    assert rec.counter("autotune.candidate.failed") == 1
    monkeypatch.setattr(autotune, "SMEM_LIMIT_BYTES", 16)
    with pytest.raises(RuntimeError, match="no viable tiling"):
        autotune.autotune_dwt(p, "fused", reps=1, cache=tmp_path / "b")
    with pytest.raises(ValueError, match="onthefly"):
        autotune.autotune_dwt(p, "dense", n_shards=2)
    with pytest.raises(ValueError, match="streaming"):
        autotune.autotune_dwt(p, "fused", n_shards=2, lchunk=4)


@pytest.mark.parametrize("impl", ["fused", "ragged"])
def test_sweep_scores_a_chunk_of_the_transform(tmp_path, rec, monkeypatch,
                                               impl):
    """Each candidate is timed on one V-lane chunk of the plan's transform:
    the batched inverse (on the dense kernel for a ragged plan) then the
    batched forward, both with the candidate's kernels at batch=V."""
    p = tb.build_plan(8, pad_to=8, device="cpu")
    calls = []
    for name, maker in (("dwt", "make_dwt_fn"), ("idwt", "make_idwt_fn")):
        def spy(plan, im, *, _orig=getattr(tops, maker), _name=name, **kw):
            calls.append((_name, im, kw["tk"], kw["batch"]))
            return _orig(plan, im, **kw)
        monkeypatch.setattr(tops, maker, spy)
    runs = []
    for name in ("inverse_clustered_batch", "forward_clustered_batch"):
        def count(plan, x, *, _orig=getattr(tb, name), _name=name, **kw):
            runs.append((_name, tuple(x.shape)))
            return _orig(plan, x, **kw)
        monkeypatch.setattr(tb, name, count)
    cfg = autotune.autotune_dwt(p, impl, Vs=(2,), reps=1,
                                cache=tmp_path / "c.json")
    cands = autotune.candidate_tiles(p.n_padded, 8, 16, impl)
    inv_impl = "dense" if impl == "ragged" else impl
    assert sorted(calls) == sorted(
        [("dwt", impl, t["tk"], 2) for t in cands]
        + [("idwt", inv_impl, t["tk"], 2) for t in cands])
    # a warmup and reps=1 timed calls a candidate, inverse then forward
    assert runs == [("inverse_clustered_batch", (2, 8, 15, 15)),
                    ("forward_clustered_batch", (2, 16, 16, 16))] \
        * (2 * len(cands))
    assert cfg["V"] == 2


def test_host_peak_rss_counts_growth_only(rec, monkeypatch):
    """plan.host_peak_rss rises only when a build raised the process's
    peak, by the growth; reset_host_peak_rss restarts the baseline, so the
    next build charges the whole peak."""
    from repro_torch.plan import transform as tt
    peaks = iter([100, 100, 90, 150, 150])
    monkeypatch.setattr(tt, "_host_peak_rss", lambda: next(peaks))
    monkeypatch.setattr(tt, "_LAST_PEAK_RSS", 0)
    seen = []
    for _ in range(4):
        tt._bump_host_peak_rss()
        seen.append(rec.counter("plan.host_peak_rss"))
    assert seen == [100, 100, 100, 150]
    r2 = obs.Recorder()
    obs.set_recorder(r2)
    tplan.reset_host_peak_rss()
    tt._bump_host_peak_rss()
    assert r2.counter("plan.host_peak_rss") == 150


def test_tuned_fns_run_the_winner(tmp_path):
    B = 8
    p = tb.build_plan(B, pad_to=8, device="cpu")
    kw = dict(Vs=(2,), reps=1, cache=tmp_path / "t.json")
    fwd = autotune.tuned_dwt_fn(p, "fused", **kw)
    inv = autotune.tuned_idwt_fn(p, "fused", **kw)
    rng = np.random.default_rng(0)
    rhs = torch.as_tensor(rng.normal(size=(2, p.n_padded, 2 * B, 8, 2)))
    lhs = torch.as_tensor(rng.normal(size=(2, p.n_padded, B, 8, 2)))
    ref_f = tops.make_dwt_fn(p, "fused", batch=2)
    ref_i = tops.make_idwt_fn(p, "fused", batch=2)
    np.testing.assert_allclose(fwd(p, rhs).numpy(), ref_f(p, rhs).numpy(),
                               rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(inv(p, lhs).numpy(), ref_i(p, lhs).numpy(),
                               rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize("B, dtype, kw", [
    (4, torch.float64, {}), (8, torch.float64, {}),
    (8, torch.float64, dict(lchunk=4)), (8, torch.float64, dict(V=2)),
    (8, torch.float64, dict(impl="ragged")),
    (8, torch.float32, {})])
def test_plan_measure_resolves_measured(tmp_path, rec, B, dtype, kw):
    t = tplan(B, dtype, device="cpu", tune="measure", tune_reps=1,
              tune_cache=tmp_path / "tune.json", **kw)
    s = t.schedule
    assert s.source == "measured" and t.tune == "measure"
    assert s.per_transform_s > 0 and s.V in tplan.AUTO_V_CANDIDATES
    assert s.impl in (("fused", "onthefly") if "impl" not in kw
                      else (kw["impl"],))
    assert s.lchunk == kw.get("lchunk")
    d = t.describe()
    assert d["source"] == "measured" and d["tune"] == "measure"
    assert d["obs"]["counters"]["autotune.cache.miss"] >= 1
    assert (tmp_path / "tune.json").exists()
    fhat = tsoft.random_coeffs(B, 5)
    f = t.inverse(fhat)
    if dtype == torch.float64:
        j = jplan(B)
        np.testing.assert_allclose(f.numpy(), np.asarray(j.inverse(fhat)),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            t.forward(f).numpy(), np.asarray(j.forward(jnp.asarray(
                f.numpy()))), rtol=RTOL, atol=ATOL)
    else:
        err = np.abs(t.forward(f).numpy() - fhat).max() / np.abs(fhat).max()
        assert err < autotune.FP32_ROUNDTRIP_BOUNDS[B]


def test_plan_tune_env_and_static_pins(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_TUNE", "measure")
    t = tplan(4, device="cpu", tune_reps=1, tune_cache=tmp_path / "e.json")
    assert t.schedule.source == "measured"
    # an explicit tl pins the schedule: static resolution
    tr = tplan(8, device="cpu", impl="ragged", tl=4, tune_reps=1,
               tune_cache=tmp_path / "e.json")
    assert tr.tune == "measure" and tr.schedule.source == "static"
    monkeypatch.setenv("REPRO_PLAN_TUNE", "fast")
    with pytest.raises(ValueError, match="tune"):
        tplan(4, device="cpu")
    assert autotune.static_overlap(1) == "off"
    assert autotune.static_overlap(4) == "pipelined"


def test_time_fn_host_clock_and_trace_check(rec):
    calls = []
    per = obs.time_fn(lambda x: calls.append(x), 3, reps=4, name="t.fn",
                      device=torch.device("cpu"), tag=1)
    assert len(calls) == 5 and per >= 0
    (ev,) = [e for e in rec.events() if e["name"] == "t.fn"]
    assert ev["args"]["clock"] == "host" and ev["args"]["reps"] == 4
    doc = rec.chrome_trace()
    assert obs.check_chrome_trace(doc, required_names=("t.fn",)) == []
    bad = {"traceEvents": [dict(ev, ts=5.0), dict(ev, ts=1.0, dur=-1)]}
    fails = obs.check_chrome_trace(bad, required_names=("missing",))
    assert any("monotonic" in f for f in fails)
    assert any("negative" in f for f in fails)
    assert any("missing" in f for f in fails)
    assert obs.check_chrome_trace({}) == ["trace has no traceEvents"]


def test_profile_so3_check_on_cpu(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    assert profile_so3.main(["--bandwidth", "8", "--check", "--device", "cpu",
                             "--trace", str(trace)]) == 0
    out = capsys.readouterr().out
    assert "trace check: OK" in out and "[measured" in out
    doc = json.loads(trace.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert set(profile_so3.REQUIRED_SPANS) <= names
