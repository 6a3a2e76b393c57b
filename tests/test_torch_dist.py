"""repro_torch mesh plans across 2 and 4 gloo ranks on the CPU, one
spawn of tests/progs/torch_dist.py per world size (one process a rank).
The reference's single-device transforms (repro.plan(B)) are computed
here and handed to the ranks through tmp_path; every rank must return
the same tensors (the global-array contract), within rtol 1e-11 /
atol 1e-11 of the reference (tests/test_parallel.py), pipelined == off
bit for bit, one all-to-all per V-chunk and direction, and rotations
matched on the mesh equal to the local engine's."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import plan as jplan  # noqa: E402
from repro.core import soft as jsoft  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROG = ROOT / "tests" / "progs" / "torch_dist.py"
BS = (8, 16)
IMPLS = ("fused", "dense", "reference")
MODES = ("off", "pipelined")
RTOL = ATOL = 1e-11


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def run(request, tmp_path_factory):
    world = request.param
    d = tmp_path_factory.mktemp(f"world{world}")
    arrays, ref = {"Bs": np.array(BS)}, {}
    for B in BS:
        j = jplan(B, V=2)
        fhats = np.stack([jsoft.random_coeffs(B, seed=s) for s in range(3)])
        f_ref = np.asarray(j.inverse_batch(jnp.asarray(fhats)))
        arrays[f"fhats{B}"], arrays[f"f_ref{B}"] = fhats, f_ref
        ref[B] = {"inverse": f_ref, "forward":
                  np.asarray(j.forward_batch(jnp.asarray(f_ref)))}
    np.savez(d / "in.npz", **arrays)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "OMP_NUM_THREADS": "1", "HOME": str(d)}
    procs = [subprocess.Popen(
        [sys.executable, str(PROG), str(r), str(world), str(d / "init"),
         str(d / "in.npz"), str(d)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    outs = [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]
    infos = [json.loads((d / f"rank{r}.json").read_text())
             for r in range(world)]
    return world, outs, infos, ref


def test_every_rank_returns_the_whole_result(run):
    world, outs, infos, _ = run
    for r in range(1, world):
        assert outs[r].keys() == outs[0].keys()
        for k in outs[0]:
            assert np.array_equal(outs[r][k], outs[0][k]), (r, k)
        assert infos[r] == infos[0], r


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("B", BS)
def test_single_transforms_match_reference(run, B, impl):
    _, outs, infos, ref = run
    o = outs[0]
    np.testing.assert_allclose(o[f"B{B}_{impl}_inverse"], ref[B]["inverse"][0],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(o[f"B{B}_{impl}_forward"], ref[B]["forward"][0],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("B", BS)
def test_batches_match_reference(run, B, impl, mode):
    world, outs, infos, ref = run
    o = outs[0]
    tag = f"B{B}_{impl}"
    np.testing.assert_allclose(o[f"{tag}_inverse_batch_{mode}"],
                               ref[B]["inverse"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(o[f"{tag}_forward_batch_{mode}"],
                               ref[B]["forward"], rtol=RTOL, atol=ATOL)
    # 3 requests on V = 2 lanes: 2 chunks a direction, one all-to-all each
    assert infos[0]["stats"][f"{tag}_{mode}"] == \
        {"launches": 4, "transforms": 6, "padded_lanes": 2}
    assert infos[0]["all_to_alls"][f"{tag}_{mode}"] == \
        {"forward": 2, "inverse": 2}
    tk, V, overlap, n_shards = infos[0]["schedule"][tag]
    assert (V, overlap, n_shards) == (2, "pipelined", world)


@pytest.mark.parametrize("B", BS)
def test_pipelined_equals_off_bitwise(run, B):
    o = run[1][0]
    for impl in IMPLS:
        for d in ("inverse", "forward"):
            k = f"B{B}_{impl}_{d}_batch_"
            assert np.array_equal(o[k + "off"], o[k + "pipelined"]), k


def test_measured_mesh_schedule_and_overlap(run):
    world, outs, infos, ref = run
    source, impl, tk, V, overlap = infos[0]["measured"]
    assert (source, impl) == ("measured", "fused")
    assert V in (1, 2, 4, 8) and overlap in MODES
    B = BS[0]
    n_padded = -(-(B * (B + 1) // 2) // world) * world
    assert (n_padded // world) % tk == 0
    np.testing.assert_allclose(outs[0]["measured_inverse"],
                               ref[B]["inverse"][0], rtol=RTOL, atol=ATOL)
    ov = infos[0]["overlap"]
    assert ov["overlap"] in MODES and ov["per_transform_s"] > 0


def test_mesh_correlation_matches_local_engine(run):
    info = run[2][0]
    assert info["correlation_keys_equal"] == [True] * 3
    assert max(info["correlation_errors"]) < 1.5
