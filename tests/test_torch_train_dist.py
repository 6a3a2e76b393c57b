"""The port's distributed training pieces across 2 and 4 gloo ranks on the
CPU, one spawn of tests/progs/torch_train_dist.py per world size (one
process a rank): compressed_allreduce (float32 reduce-scatter, int8
all-gather with error feedback) and pipeline_apply (GPipe over ranks),
held to the assertions of the reference's tests/progs/dist_compress.py
and dist_pipeline.py, and to the reference's single-device quantizer
(repro.train.compress.ef_quantize) on each rank's shard of the sum."""
import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import compress as jcompress  # noqa: E402
from repro_torch.train.pipeline import bubble_fraction  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROG = ROOT / "tests" / "progs" / "torch_train_dist.py"
_spec = importlib.util.spec_from_file_location("torch_train_dist", PROG)
_prog = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_prog)
L, inputs = _prog.L, _prog.inputs          # the ranks' seeded inputs


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def run(request, tmp_path_factory):
    world = request.param
    d = tmp_path_factory.mktemp(f"world{world}")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "OMP_NUM_THREADS": "1", "HOME": str(d)}
    procs = [subprocess.Popen(
        [sys.executable, str(PROG), str(r), str(world), str(d / "init"),
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    return world, [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


def test_compressed_allreduce(run):
    world, outs = run
    g, _, _ = inputs(world)
    expect = g.sum(axis=0)
    for r in range(world):      # every rank holds the same compressed sum
        np.testing.assert_array_equal(outs[r]["summed"], outs[0]["summed"])
        np.testing.assert_allclose(outs[r]["summed"], expect,
                                   atol=np.abs(expect).max() / 100)
    # error feedback: each rank keeps the quantization residual of its own
    # shard
    err = np.concatenate([o["err"] for o in outs])
    assert np.abs(err).max() <= np.abs(expect).max() / 120
    assert np.abs(err).max() > 0
    # the reference's quantizer on each shard of the (float32) sum: equal
    # within one int8 step of each block (the sums' order may differ)
    n = expect.size // world
    for r in range(world):
        q, scale, jerr = jcompress.ef_quantize(
            jnp.asarray(expect[r * n:(r + 1) * n]), jnp.zeros(n, jnp.float32))
        deq = np.asarray(jcompress.ef_dequantize(q, scale, (n,)))
        step = np.repeat(np.asarray(scale), jcompress.BLOCK)[:n]
        assert np.all(np.abs(outs[0]["summed"][r * n:(r + 1) * n] - deq)
                      <= step * 1.001), r
        assert np.all(np.abs(outs[r]["err"] - np.asarray(jerr))
                      <= step * 1.001), r


def test_pipeline_matches_sequential(run):
    world, outs = run
    _, ws, x = inputs(world)
    h = x.astype(np.float64)
    for i in range(L):
        h = np.tanh(h @ ws[i])
    for o in outs:
        np.testing.assert_array_equal(o["pipeline"], outs[0]["pipeline"])
        np.testing.assert_allclose(o["pipeline"], h, rtol=2e-6, atol=2e-6)
        # one send / receive pair a tick, T + S - 1 ticks
        assert o["pairs"].tolist() == [2] * (x.shape[0] + world - 1)


def test_bubble_fraction():
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-12
    assert bubble_fraction(1, 8) == 0.0
