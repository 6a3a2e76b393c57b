"""repro_torch.so3.SO3Service on the CPU: the reference's service tests
(tests/test_so3.py) ported -- packing, mixed arrival order, the
background worker, cancellation, admission, deadlines, retry with
backoff, the error after retries, warm_bandwidths, the mixed-bandwidth
fuzz with bitwise parity against direct execution -- plus
infer_bandwidth and the serve_so3 CLI."""
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import plan as tplan  # noqa: E402
from repro_torch.core import soft  # noqa: E402
from repro_torch.launch import serve_so3  # noqa: E402
from repro_torch.obs import Recorder  # noqa: E402
from repro_torch.so3 import (Cancelled, CorrelationEngine, Expired,  # noqa: E402
                             Rejected, SO3Service, ServiceError, result_key,
                             s2)
from repro_torch.so3.correlate import angle_error, random_rotation  # noqa: E402
from repro_torch.so3.service import infer_bandwidth  # noqa: E402


def planted_pair(B, seed):
    true = random_rotation(seed)
    g = soft.random_s2_coeffs(B, seed=seed)
    return s2.rotate_s2_coeffs(g, true), g, true


def service(bandwidths, **kw):
    kw.setdefault("lane_width", 2)
    return SO3Service(bandwidths=bandwidths, device="cpu",
                      recorder=Recorder(), **kw)


def recovered(res, true, B):
    return all(angle_error(e, t) < 1.5 * np.pi / B
               for e, t in zip(res.euler, true))


def test_service_packs_concurrent_requests_into_one_launch():
    B = 8
    svc = service((B,), lane_width=4)
    warm = svc.warmup()
    st = svc.stats()
    assert st["launches"] == 0                   # warmup launches excluded
    assert set(st["warmup_parts_s"][B]) == {"plan_s", "launch_s"}
    assert warm[B] >= st["warmup_parts_s"][B]["launch_s"] > 0
    pairs = [planted_pair(B, seed=40 + n) for n in range(3)]
    futs = [svc.submit(f, g) for f, g, _ in pairs]
    assert svc.drain() == 3
    st = svc.stats()
    assert st["launches"] == 1 and st["transforms"] == 3
    assert st["occupancy"] == pytest.approx(0.75)
    assert st["latency_s"]["p95"] > 0
    for fut, (f, g, true) in zip(futs, pairs):
        assert recovered(fut.result(timeout=0), true, B)


def test_service_latency_clock_includes_the_peak_search(monkeypatch):
    """latency_s runs from submit to the result (the peak search
    included); grids_ready_s stops when the group's grids exist."""
    from repro_torch.so3 import service as service_mod
    real = service_mod.peak_euler

    def slow(*a, **kw):
        time.sleep(0.05)
        return real(*a, **kw)

    monkeypatch.setattr(service_mod, "peak_euler", slow)
    B = 4
    svc = service((B,))
    f, g, true = planted_pair(B, seed=44)
    fut = svc.submit(f, g)
    assert svc.drain() == 1
    assert recovered(fut.result(timeout=0), true, B)
    st = svc.stats()
    lat, ready = st["latency_s"], st["grids_ready_s"]
    assert lat["max"] - ready["max"] >= 0.05
    assert 0 < ready["p50"] < lat["p50"]


def test_service_mixed_arrival_order_lands_in_correct_lanes():
    svc = service((4, 8))
    jobs, futs = [], []
    for n, B in enumerate([8, 4, 8, 4, 8]):      # mixed arrival order
        f, g, true = planted_pair(B, seed=50 + n)
        jobs.append((B, true))
        futs.append(svc.submit(f, g, refine=False))
    assert svc.drain() == 5
    st = svc.stats()
    assert st["engines"][8]["launches"] == 2
    assert st["engines"][4]["launches"] == 1
    assert st["launches"] == 3
    for fut, (B, true) in zip(futs, jobs):
        assert recovered(fut.result(timeout=0), true, B)


def test_service_background_worker_smoke():
    B = 8
    svc = service((B,), max_wait_ms=50.0)
    svc.warmup()
    svc.start()
    try:
        pairs = [planted_pair(B, seed=60 + n) for n in range(4)]
        futs = [svc.submit(f, g) for f, g, _ in pairs]
        results = [fut.result(timeout=120) for fut in futs]
    finally:
        svc.stop()
    for res, (_, _, true) in zip(results, pairs):
        assert recovered(res, true, B)
    assert svc.stats()["completed"] == 4


def test_service_stop_without_drain_cancels_queued():
    svc = service((4,))
    f, g, _ = planted_pair(4, seed=70)
    fut = svc.submit(f, g)
    got = {}

    def waiter():
        try:
            got["res"] = fut.result(timeout=30)
        except BaseException as e:                # noqa: BLE001 - test probe
            got["exc"] = e

    th = threading.Thread(target=waiter)
    th.start()
    svc.stop(drain=False)
    th.join(timeout=30)
    assert not th.is_alive(), "waiter blocked forever on a dropped promise"
    exc = got.get("exc")
    assert isinstance(exc, Cancelled) and isinstance(exc, ServiceError)
    assert (exc.seq, exc.B) == (1, 4)
    st = svc.stats()
    assert st["queued"] == 0 and st["cancelled"] == 1
    assert st["resolved"] == st["submitted"] == 1
    with pytest.raises(Rejected, match="closed"):
        svc.submit(f, g).result(timeout=0)


def test_service_admission_rejects_when_queue_full():
    svc = service((4,), max_queue=2)
    f, g, _ = planted_pair(4, seed=71)
    futs = [svc.submit(f, g, refine=False) for _ in range(4)]
    shed = [fu for fu in futs if fu.done()]
    assert len(shed) == 2 and shed == futs[2:]   # FIFO admission
    for fu in shed:
        with pytest.raises(Rejected, match="queue full") as ei:
            fu.result(timeout=0)
        assert ei.value.B == 4
    assert svc.drain() == 2
    for fu in futs[:2]:
        assert fu.result(timeout=0).index is not None
    st = svc.stats()
    assert st["completed"] == 2 and st["rejected"] == 2 and st["shed"] == 2
    assert st["submitted"] == st["resolved"] == 4


def test_service_deadline_sheds_expired_requests():
    svc = service((4,))
    f, g, _ = planted_pair(4, seed=72)
    ok = svc.submit(f, g, refine=False)
    doomed = svc.submit(f, g, refine=False, deadline_s=0.01)
    time.sleep(0.05)
    assert svc.drain() == 1
    assert ok.result(timeout=0).index is not None
    with pytest.raises(Expired, match="deadline") as ei:
        doomed.result(timeout=0)
    assert ei.value.B == 4
    st = svc.stats()
    assert st["expired"] == 1 and st["completed"] == 1 and st["shed"] == 1
    assert st["submitted"] == st["resolved"] == 2


def test_service_retries_failed_launch_with_backoff(monkeypatch):
    svc = service((4,), max_retries=1, retry_backoff_s=0.01)
    eng = svc.engine(4)
    real = eng.correlation_grids
    calls = {"n": 0}

    def flaky(fs, gs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected transient launch failure")
        return real(fs, gs)

    monkeypatch.setattr(eng, "correlation_grids", flaky)
    f, g, true = planted_pair(4, seed=73)
    fut = svc.submit(f, g)
    assert svc.drain() == 2                  # two launch attempts, one request
    assert recovered(fut.result(timeout=0), true, 4)
    st = svc.stats()
    assert st["retries"] == 1 and st["completed"] == 1 and st["failed"] == 0
    assert calls["n"] == 2
    assert svc.obs.counter("service.retry") == 1


def test_service_surfaces_launch_error_after_retries(monkeypatch):
    svc = service((4,), max_retries=1, retry_backoff_s=0.005)
    eng = svc.engine(4)

    def broken(fs, gs):
        raise RuntimeError("injected permanent launch failure")

    monkeypatch.setattr(eng, "correlation_grids", broken)
    f, g, _ = planted_pair(4, seed=74)
    fut = svc.submit(f, g)
    svc.drain()
    with pytest.raises(RuntimeError, match="permanent"):
        fut.result(timeout=0)
    st = svc.stats()
    assert st["failed"] == 1 and st["retries"] == 1 and st["completed"] == 0
    assert st["submitted"] == st["resolved"] == 1


def test_warm_bandwidths_reports_plan_cache():
    tplan.clear_cache()
    assert tplan.warm_bandwidths() == {}
    tplan(4, device="cpu")
    warm = tplan.warm_bandwidths()
    assert warm.get(4, 0) >= 1 and 16 not in warm
    svc = service((4, 16))
    svc.engine(4)
    assert svc._warm(4) and not svc._warm(16)


def test_service_mesh_raises_not_ported(tmp_path):
    """SO3Service(mesh=): without a process group the engine build raises
    (no local fallback); on a one-rank gloo mesh every request resolves
    exactly once, equal to direct unbatched execution."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    with pytest.raises(RuntimeError, match="process group"):
        SO3Service(bandwidths=(4,), device="cpu", mesh=object()).engine(4)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        svc = service((8,), mesh=mesh, axis=("data",))
        pairs = [planted_pair(8, seed=90 + n) for n in range(3)]
        futs = [svc.submit(f, g) for f, g, _ in pairs]
        assert svc.drain() == 3
        assert svc.engine(8).transform.mesh is mesh
        ref = CorrelationEngine(8, lane_width=1, device="cpu")
        for fut, (f, g, true) in zip(futs, pairs):
            res = fut.result(timeout=0)
            assert recovered(res, true, 8)
            assert result_key(res) == result_key(ref.match(f, g))
        st = svc.stats()
        assert st["completed"] == 3 and st["failed"] == st["retries"] == 0
    finally:
        tplan.clear_cache()
        dist.destroy_process_group()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_service_mixed_bandwidth_fuzz_bitwise_parity(seed):
    """A random interleaving of submissions across B in {4, 8, 16}
    resolves every future exactly once, each BITWISE-identical to direct
    unbatched execution of the same pair, while stats() and the service.*
    counters stay monotone across rounds."""
    rng = np.random.default_rng(1000 + seed)
    Bs = (4, 8, 16)
    svc = service(Bs)
    ref = {B: CorrelationEngine(B, lane_width=1, device="cpu") for B in Bs}
    mono: dict[str, int] = {}
    last: dict[str, int] = {}
    for _round in range(3):
        jobs = []
        for _ in range(int(rng.integers(3, 8))):
            B = int(rng.choice(Bs))
            f, g, _ = planted_pair(B, seed=int(rng.integers(0, 2 ** 31)))
            refine = bool(rng.integers(0, 2))
            jobs.append((B, f, g, refine, svc.submit(f, g, refine=refine)))
        assert svc.drain() == len(jobs)
        for B, f, g, refine, fut in jobs:
            got = fut.result(timeout=0)
            want = ref[B].match(f, g, refine=refine)
            assert result_key(got) == result_key(want), (B, refine)
        st = svc.stats()
        for k in ("submitted", "resolved", "completed", "launches",
                  "transforms"):
            assert st[k] >= last.get(k, 0), k
        last = st
        for name in ("service.completed", "service.rejected",
                     "service.expired", "service.cancelled"):
            v = svc.obs.counter(name)
            assert v >= mono.get(name, 0), name
            mono[name] = v
    assert last["submitted"] == last["resolved"] == last["completed"]
    assert last["shed"] == last["failed"] == 0


def test_infer_bandwidth():
    assert infer_bandwidth(np.zeros((8, 15))) == 8       # coeffs
    assert infer_bandwidth(np.zeros((16, 16))) == 8      # samples
    assert infer_bandwidth(torch.zeros(16, 16)) == 8
    with pytest.raises(ValueError, match="bandwidth"):
        infer_bandwidth(np.zeros((5, 7)))


@pytest.mark.parametrize("threaded", [False, True])
def test_serve_so3_cli(threaded, capsys):
    argv = ["--bandwidth", "8", "--requests", "6", "--device", "cpu"]
    st = serve_so3.main(argv + (["--threaded"] if threaded else []))
    assert st["completed"] == st["submitted"] == 6
    assert st["failed"] == st["shed"] == 0
    assert "OK: all rotations recovered" in capsys.readouterr().out


def test_serve_so3_cli_mesh_exits_with_reason(capsys):
    """--mesh-shards N needs N ranks: a single process exits with the
    reason for N = 2, and serves on a one-rank gloo group it starts (and
    ends) for N = 1."""
    import torch.distributed as dist
    with pytest.raises(SystemExit, match="needs a process group of 2"):
        serve_so3.main(["--mesh-shards", "2", "--device", "cpu"])
    st = serve_so3.main(["--bandwidth", "8", "--requests", "4",
                         "--mesh-shards", "1", "--device", "cpu"])
    assert st["completed"] == st["submitted"] == 4 and st["failed"] == 0
    out = capsys.readouterr().out
    assert "mesh: 1 shards" in out and "OK: all rotations recovered" in out
    assert not dist.is_initialized()
    # the group's plans went with it: none holds the dead group
    assert tplan.cache_stats()["mesh_size"] == 0
    tplan.clear_cache()
