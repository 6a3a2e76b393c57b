"""The port's sharded MoE path (repro_torch.models.moe with ctx: expert
and sequence parallelism over the model group) against the reference's
``_moe_sharded`` on identical weights and inputs made from seeds.

The reference side runs in one subprocess (tests/progs/sharded_ref.py)
on 4 fake XLA CPU devices with Auto-axis meshes; the port side under
gloo, one process a rank (tests/progs/torch_sharded.py), at 4 ranks
(meshes 1x4, 2x2, 4x1), 2 ranks (1x2, 2x1) and 1 rank (1x1).  Each rank
holds its data rows and its E / n_model experts; its output is held to
its rows of the reference's global output.

Tolerances are tests/test_torch_moe.py's for the local path: the output
within 1e-4 of max|reference| (float32), aux within 1e-6 relative.  The
sharded path is not the local one (each rank routes its own sequence
slice with its own capacity; aux is a mean of per-rank terms), so it is
held to the reference's sharded path.  A planted fault -- the
all-to-all's received chunks rotated by one source rank, handing tokens
to the wrong expert -- must fail the comparison."""
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROGS = ROOT / "tests" / "progs"
ARCHS = ("olmoe-1b-7b", "llama4-maverick-400b-a17b")
WORLDS = {4: ("1x4", "2x2", "4x1"), 2: ("1x2", "2x1"), 1: ("1x1",)}
MESHES = [m for ms in WORLDS.values() for m in ms]
TOL, AUX_RTOL = 1e-4, 1e-6
B = 4


def _env(d, **extra):
    return {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
            "OMP_NUM_THREADS": "1", "HOME": str(d), "JAX_PLATFORMS": "cpu",
            **extra}


def run_reference(part, d):
    """The reference's sharded results on every mesh, in one process."""
    out = d / f"ref_{part}.npz"
    p = subprocess.run(
        [sys.executable, str(PROGS / "sharded_ref.py"), part, str(out),
         *MESHES], capture_output=True, text=True, timeout=600, cwd=d,
        env=_env(d, XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return out


def run_port(part, ref, d):
    """{world: [rank outputs]}: one spawn of gloo ranks per world size."""
    outs = {}
    for world, meshes in WORLDS.items():
        wd = d / f"{part}_world{world}"
        wd.mkdir()
        procs = [subprocess.Popen(
            [sys.executable, str(PROGS / "torch_sharded.py"), part, str(r),
             str(world), str(wd / "init"), str(ref), str(wd), *meshes],
            env=_env(d), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        logs = [p.communicate(timeout=600)[0] for p in procs]
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
        outs[world] = [dict(np.load(wd / f"rank{r}.npz"))
                       for r in range(world)]
    return outs


def world_of(mesh):
    nd, nm = (int(v) for v in mesh.split("x"))
    return nd * nm, nd, nm


def rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_sharded")
    ref = run_reference("moe", d)
    return dict(np.load(ref)), run_port("moe", ref, d)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_moe_matches_reference(runs, arch, mesh):
    ref, port = runs
    world, nd, _ = world_of(mesh)
    want_aux = float(ref[f"{arch}/{mesh}/aux"])
    for o in port[world]:
        dr = int(o[f"{mesh}/data_rank"])
        rows = slice(dr * B // nd, (dr + 1) * B // nd)
        want = ref[f"{arch}/{mesh}/out"][rows]
        assert rel(o[f"{arch}/{mesh}/out"], want) < TOL
        assert abs(float(o[f"{arch}/{mesh}/aux"]) / want_aux - 1) < AUX_RTOL


@pytest.mark.parametrize("mesh", MESHES)
def test_collectives_per_call(runs, mesh):
    """Per moe_apply call: 2 all-to-alls over the model group, one
    all-gather of the sequence slices when the model axis splits the
    sequence (S = 16), one all-reduce of aux; the planted-fault call of
    each arch (n_model > 1) counts too."""
    _, port = runs
    world, _, nm = world_of(mesh)
    calls = len(ARCHS) * (2 if nm > 1 else 1)
    for o in port[world]:
        assert o[f"{mesh}/collectives/all-to-all"][0] == 2 * calls
        assert o[f"{mesh}/collectives/all-reduce"][0] == calls
        gathers = o.get(f"{mesh}/collectives/all-gather", [0])[0]
        assert gathers == (calls if nm > 1 else 0)


@pytest.mark.parametrize("mesh", [m for m in MESHES if world_of(m)[2] > 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_planted_all_to_all_fault_is_caught(runs, arch, mesh):
    ref, port = runs
    world, nd, _ = world_of(mesh)
    errs = []
    for o in port[world]:
        dr = int(o[f"{mesh}/data_rank"])
        rows = slice(dr * B // nd, (dr + 1) * B // nd)
        errs.append(rel(o[f"{arch}/{mesh}/out_fault"],
                        ref[f"{arch}/{mesh}/out"][rows]))
    assert max(errs) > 100 * TOL, errs
