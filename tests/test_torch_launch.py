"""The port's launch tooling (repro_torch.launch.flops, .specs, .dryrun,
.mesh) against the reference's (tests/test_launch.py's unit programs and
repro.launch.dryrun's build_train / build_prefill / build_decode).

FLOPs: the counter (a TorchDispatchMode over the eager forward and
backward, meta tensors) must give the reference's numbers on its unit
programs exactly -- a matmul, a batched dot, an FFT (5 * 64 * log2 64),
a loop of 7 matmuls, recompute counted -- and the dry run's
``flops_analytic_global`` of the reduced smollm-135m / olmoe-1b-7b
train_4k / prefill_32k / decode_32k cells, and llama4-maverick's
train_4k (a shared expert: 3-D matmuls inside the MoE, whose backward
must count as the MoE's), on a (2, 4) mesh within 1 % of
the reference's ``analytic_flops`` of ``build_train`` / ``build_prefill``
/ ``build_decode`` (8 fake XLA devices, Auto axes; a subprocess).  The
specs allocate nothing; the dry run runs in one process with no process
group."""
import functools
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import batched  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.flops import (Counter, analytic_bytes,  # noqa: E402
                                      analytic_flops)
from repro_torch.models import sharding as tsh  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLOPS_RTOL = 0.01
CELLS = [(a, s) for a in ("smollm-135m", "olmoe-1b-7b")
         for s in ("train_4k", "prefill_32k", "decode_32k")] \
    + [("llama4-maverick-400b-a17b", "train_4k")]   # a shared expert


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the reference's unit programs
# ---------------------------------------------------------------------------

def test_flops_matmul():
    assert analytic_flops(lambda x, y: x @ y, meta(64, 128),
                          meta(128, 32)) == 2 * 64 * 128 * 32


def test_flops_loop_multiplies():
    def f(x):
        for _ in range(7):
            x = x @ x
        return x
    assert analytic_flops(f, meta(16, 16)) == 7 * 2 * 16 * 16 * 16


def test_flops_batched_dot():
    got = analytic_flops(lambda x, y: torch.einsum("bij,bjk->bik", x, y),
                         meta(4, 8, 16), meta(4, 16, 8))
    assert got == 2 * 4 * 8 * 16 * 8


def test_flops_fft():
    assert analytic_flops(torch.fft.fft, meta(64, dtype=torch.complex64)) \
        == 5 * 64 * 6
    # real transforms: the input's element count times log2 of the length
    assert analytic_flops(torch.fft.rfft, meta(64)) == 5 * 64 * 6
    assert analytic_flops(lambda z: torch.fft.irfft(z, 64),
                          meta(33, dtype=torch.complex64)) == 5 * 33 * 6


def _grad_of(loss_fn):
    def run(x):
        x = x.detach().requires_grad_()
        return torch.autograd.grad(loss_fn(x), x)
    return run


def test_flops_remat_counts_recompute():
    """recompute >= plain (tests/test_launch.py); with a body whose saved
    activation must be rebuilt, exactly one more matmul."""
    a = meta(32, 32)
    plain = analytic_flops(_grad_of(lambda v: torch.sum((v @ v) ** 2)), a)
    remat = analytic_flops(_grad_of(lambda v: torch.sum(checkpoint(
        lambda u: u @ u, v, use_reentrant=False) ** 2)), a)
    assert remat >= plain
    mm = 2 * 32 ** 3

    def body(u):
        return (u @ u) @ u
    plain2 = analytic_flops(_grad_of(lambda v: torch.sum(body(v) ** 2)), a)
    remat2 = analytic_flops(_grad_of(lambda v: torch.sum(checkpoint(
        body, v, use_reentrant=False) ** 2)), a)
    assert remat2 == plain2 + mm


def test_bytes_counts_operands_results_and_io():
    got = analytic_bytes(lambda x, y: x @ y, meta(64, 128), meta(128, 32))
    op = (64 * 128 + 128 * 32 + 64 * 32) * 4
    assert got == 2 * op


def test_sharded_modules_scale_by_the_mesh():
    lin = torch.nn.Linear(8, 8, bias=False, device="meta")
    with Counter(sharded=(lin,)) as c:
        x = meta(4, 8).requires_grad_()
        torch.autograd.grad(lin(x @ torch.eye(8, device="meta")).sum(), x)
    # forward: x @ eye, then lin; backward to x only: lin's dX, then
    # (x @ eye)'s dX -- lin's two inside the sharded region
    one = 2 * 4 * 8 * 8
    assert c.flops == 4 * one and c.sharded_flops == 2 * one
    assert c.global_flops(mesh_size=8, data_size=2) == 2 * 2 * one \
        + 8 * 2 * one


# ---------------------------------------------------------------------------
# the dry run's cells against the reference's build_* functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_flops(tmp_path_factory):
    d = tmp_path_factory.mktemp("flops")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "HOME": str(d), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    p = subprocess.run([sys.executable, str(ROOT / "tests" / "progs" /
                                            "launch_ref.py"), "flops",
                        str(d / "out.json")], capture_output=True,
                       text=True, timeout=600, env=env, cwd=d)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return json.loads((d / "out.json").read_text())


@functools.lru_cache(maxsize=None)
def _cell(arch, shape):
    """The dry run's record of a reduced cell on a (2, 4) mesh, traced
    once for every test that reads it."""
    ctx = tsh.shape_ctx((2, 4), ("data", "model"))
    return dryrun.run_cell(arch, shape, False, ctx=ctx,
                           cfg=tconfigs.reduced(arch))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_flops_match_reference(ref_flops, arch, shape):
    res = _cell(arch, shape)
    want = ref_flops[f"{arch}/{shape}"]
    assert res["flops_analytic_global"] == pytest.approx(want,
                                                         rel=FLOPS_RTOL)
    # the rank executes at least its share of the logical program
    assert res["flops_executed_per_device"] >= 0.45 * \
        res["flops_analytic_per_device"]
    if tconfigs.get(arch).moe is not None:
        calls = res["collectives"]["calls"]
        assert calls["all-to-all"] > 0 and res["flops_moe_per_device"] > 0
        if shape != "decode_32k":      # S divides the model axis: SP
            assert calls["all-gather"] > 0


@pytest.mark.parametrize("arch,shape", CELLS)
def test_placed_rank_holds_what_the_rules_give(arch, shape):
    """The rank's parameters and optimizer state at run time are the
    rules' bytes (a placed model: no parameter replicated beyond its
    placement), and so are its decode states."""
    mem = _cell(arch, shape)["memory"]
    rules, runtime = mem["argument_parts_gb"], mem["argument_runtime_parts_gb"]
    for part in ("params", "opt", "states"):
        if part in rules:
            assert runtime[part] == pytest.approx(rules[part], rel=1e-12), \
                part


@pytest.mark.parametrize("arch,shape", CELLS)
def test_collectives_list_the_parameter_gathers(arch, shape):
    """Each block gathers its data-sharded weights (one all-gather a
    dtype); a train step reduce-scatters their gradients back."""
    res = _cell(arch, shape)
    calls = res["collectives"]["calls"]
    layers = tconfigs.reduced(arch).num_layers
    assert calls["all-gather"] >= layers + 1
    if shape == "train_4k":
        assert calls["reduce-scatter"] >= layers + 1
    assert res["flops_split_per_device"] > 0


def test_soft_cell_traces_the_executor():
    ctx = tsh.shape_ctx((2, 4), ("data", "model"))
    res = dryrun.run_cell("soft_b128", "forward", False, ctx=ctx)
    assert res["collectives"]["calls"]["all-to-all"] == 1
    assert res["n_shards"] == 8 and res["flops_executed_per_device"] > 0
    assert res["flops_analytic_global"] == 8 * \
        res["flops_executed_per_device"]


# ---------------------------------------------------------------------------
# specs allocate nothing
# ---------------------------------------------------------------------------

def test_specs_no_allocation():
    ctx = tsh.shape_ctx((1, 1), ("data", "model"))
    cfg = tconfigs.get("nemotron-4-340b")   # 340B: would not fit if real
    model, placements = tspecs.params_specs(cfg, ctx)
    params = list(model.parameters())
    assert sum(p.numel() for p in params) > 3e11
    assert all(p.device.type == "meta" for p in params)
    assert set(placements) == {n for n, _ in model.named_parameters()}
    (batch, states, pos), _ = tspecs.decode_specs(cfg, 128, 32768, ctx)
    leaves = list(batch.values()) + [t for st in states for t in st.values()]
    assert all(t.device.type == "meta" for t in leaves)


def test_soft_plan_specs_match_real_plan():
    B, n = 8, 4
    real = batched.build_plan(B, torch.float32, pad_to=n, device="cpu")
    spec = tspecs.soft_plan_specs(B, n)
    assert spec.n_padded == real.n_padded
    for name in batched.PLAN_LEAVES:
        r, s = getattr(real, name), getattr(spec, name)
        assert r.shape == s.shape, name
        assert r.dtype == s.dtype, name
        assert s.device.type == "meta", name


def test_local_shape_and_placement_bytes():
    ctx = tsh.shape_ctx((2, 16, 16), ("pod", "data", "model"))
    assert tspecs.local_shape((64, 32), (("pod", "data"), "model"), ctx) \
        == (2, 2)
    assert tspecs.local_shape((64, 32), (), ctx) == (64, 32)
    t = {"w": meta(64, 32)}
    assert tspecs.placement_bytes(t, {"w": ("model",)}, ctx) == 4 * 32 * 4


def test_dryrun_cell_subprocess(tmp_path):
    """One cell on the multi-pod mesh in one process, no process group
    and no card (the reference's tests/test_launch.py cell)."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "HOME": str(tmp_path)}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "decode_32k", "--mesh", "multi", "--out",
         str(tmp_path / "dry")], capture_output=True, text=True, timeout=600,
        env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "all cells OK" in out.stdout
    cell = json.loads((tmp_path / "dry" /
                       "smollm-135m__decode_32k__multi.json").read_text())
    assert cell["devices"] == 512 and cell["mesh"] == "pod2x16x16"
    for key in ("flops_analytic_global", "flops_executed_per_device",
                "bytes_analytic_per_device", "collectives", "memory",
                "trace_s"):
        assert key in cell, key
    assert cell["memory"]["temp_gb"] is None
    assert cell["memory"]["temp_gb_reason"]
