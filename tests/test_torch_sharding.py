"""The port's sharding rules (repro_torch.models.sharding.param_placements,
repro_torch.launch.specs.state_shardings) against the reference's
(repro.models.sharding.param_shardings, repro.launch.specs
.state_shardings) for the ten published configs on both production
meshes, 16x16 and 2x16x16; and the shape-only mesh context.

The reference side runs once, in a subprocess with 512 fake XLA CPU
devices (tests/progs/launch_ref.py), on ``jax.eval_shape`` trees; the
port's on meta-device models.  The reference stacks the layers of a
pattern slot into one (G, ...) leaf; the port keeps one module per
layer, so each stacked leaf's spec is compared without its first entry,
the group axis -- None for every rule but the shared experts' wi / wo,
where the expert rule puts "model" on the group axis (kept in the test
as the one exception)."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import convert, lm as tlm  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("placements")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "HOME": str(d), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    p = subprocess.run([sys.executable, str(ROOT / "tests" / "progs" /
                                            "launch_ref.py"), "placements",
                        str(d / "out.json")], capture_output=True,
                       text=True, timeout=600, env=env, cwd=d)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return json.loads((d / "out.json").read_text())


def _norm(spec):
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


def _ctx(mesh):
    return tsh.shape_ctx(*MESHES[mesh])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_param_placements_equal_reference(ref, arch, mesh):
    cfg = tconfigs.get(arch)
    ctx = _ctx(mesh)
    model, placements = tspecs.params_specs(cfg, ctx)
    names = {id(p): n for n, p in model.named_parameters()}
    want = ref[f"{arch}/{mesh}/params"]
    groups = convert.leaf_groups(model)
    assert set(groups) == set(want)
    dropped = set()
    for path, params in groups.items():
        spec = _norm(want[path])
        if convert.is_stacked(path) and spec:
            dropped.add(spec[0])
            if spec[0] is not None:      # the shared experts' expert rule
                assert path.split("/")[-3:-1] == ["moe", "shared"], path
            spec = spec[1:]
        for p in params:
            assert placements[names[id(p)]] == spec, (path, spec)
    assert dropped <= {None, "model"}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_decode_state_placements_equal_reference(ref, arch, mesh):
    cfg = tconfigs.get(arch)
    ctx = _ctx(mesh)
    (_, states, _), (_, st_sh, _) = tspecs.decode_specs(cfg, 128, 32768,
                                                        ctx)
    want = ref[f"{arch}/{mesh}/states"]
    P = len(cfg.block_pattern)
    G = cfg.num_layers // P
    assert len(st_sh) == cfg.num_layers
    for i, placements in enumerate(st_sh):
        for key, got in placements.items():
            if i < G * P:
                spec = _norm(want[f"groups/{i % P}/{key}"])
                assert spec[0] is None
                spec = spec[1:]
            else:
                spec = _norm(want[f"tail/{i - G * P}/{key}"])
            assert got == spec, (i, key)


def test_expert_and_moe_names():
    assert tsh.is_expert("blocks.3.moe.wi")
    assert tsh.is_expert("groups/0/moe/wo".replace("/", "."))
    assert not tsh.is_expert("blocks.3.moe.shared.wi")
    assert not tsh.is_expert("blocks.3.mlp.wi")
    assert tsh.in_moe("blocks.3.moe.router")
    assert not tsh.in_moe("blocks.3.mixer.wq")


def test_production_mesh_is_shape_only_without_a_group():
    assert not torch.distributed.is_initialized()
    for multi, (shape, names) in ((False, MESHES["single"]),
                                  (True, MESHES["multi"])):
        mesh = tmesh.make_production_mesh(multi_pod=multi)
        assert isinstance(mesh, tsh.MeshSpec)
        assert (mesh.shape, mesh.axis_names) == (shape, names)
        ctx = tmesh.make_ctx(mesh)
        assert ctx.n_model == 16 and ctx.size == mesh.size
        assert ctx.dp_axes == names[:-1] and not ctx.has_groups
        assert ctx.n_data == mesh.size // 16
        assert ctx.dp == (names[:-1] if multi else "data")
    ctx = tmesh.make_ctx(tmesh.make_test_mesh(2, 4))
    assert ctx.batch_sharded(4) and not ctx.batch_sharded(3)
    assert ctx.local_rows(8) == slice(0, 4) and ctx.local_rows(1) == \
        slice(0, 1)


def test_shape_only_ctx_runs_on_meta_and_raises_on_real_tensors():
    """Without a process group a collective traces on meta tensors --
    the right shape, its bytes counted -- and raises on a real one, as
    core.parallel's mesh plans do."""
    ctx = tsh.shape_ctx((2, 4), ("data", "model"))
    tsh.reset_collectives()
    x = torch.empty((8, 3, 5), device="meta")
    assert tsh.all_to_all(x, ctx).shape == x.shape
    assert tsh.all_gather(x, ctx, dim=1).shape == (8, 12, 5)
    assert tsh.all_reduce(x, ctx, "world").shape == x.shape
    got = tsh.collective_summary()
    assert got["calls"] == {"all-to-all": 1, "all-gather": 1,
                            "all-reduce": 1}
    assert got["by_op"]["all-gather"] == 8 * 12 * 5 * 4
    assert got["total"] == (8 * 3 * 5 * 2 + 8 * 12 * 5) * 4
    real = torch.zeros((8, 3, 5))
    for fn in (lambda: tsh.all_to_all(real, ctx),
               lambda: tsh.all_gather(real, ctx, dim=1),
               lambda: tsh.all_reduce(real, ctx, "data")):
        with pytest.raises(RuntimeError, match="process group"):
            fn()
    assert tsh.constrain(real, ctx, "data", None) is real


def test_sharded_meta_model_holds_its_experts():
    """Placed at 16x16, each MoE layer holds E / 16 experts, each expert's
    inner dimension cut over the data axis."""
    cfg = tconfigs.get("olmoe-1b-7b")
    ctx = tsh.shape_ctx((16, 16), ("data", "model"))
    model = tlm.LM(cfg, device="meta")
    whole = {n: tuple(p.shape) for n, p in model.named_parameters()
             if tsh.is_expert(n)}
    tsh.place_(model, ctx)
    for b in model.blocks:
        assert b.moe.wi.shape[0] == cfg.moe.num_experts // 16
    for name, p in model.named_parameters():
        if name in whole:
            E, a, c = whole[name]
            want = (E // 16, a // 16, c) if name.endswith("wi") else \
                (E // 16, a, c // 16)
            assert tuple(p.shape) == want, name


def test_local_ctx_is_one_rank_gloo_on_the_cpu():
    with tmesh.local_ctx(torch.device("cpu")) as ctx:
        assert ctx.shape == (1, 1) and ctx.has_groups
        assert (ctx.model_rank, ctx.data_rank) == (0, 0)
        x = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(tsh.all_to_all(x, ctx), x)
        assert torch.equal(tsh.all_reduce(x, ctx, "world"), x)
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# run-time placements (place_, the bucketed gathers, the new collectives)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "nemotron-4-340b",
                                  "rwkv6-3b", "recurrentgemma-9b",
                                  "llama4-maverick-400b-a17b"])
def test_place_cuts_each_parameter_to_its_block(arch, mesh):
    """On the meta device, a placed model's parameters have the shapes
    the rules give a rank, and its bytes are the rules' bytes."""
    cfg = tconfigs.get(arch)
    ctx = _ctx(mesh)
    model, placements = tspecs.params_specs(cfg, ctx)
    whole = {n: p.shape for n, p in model.named_parameters()}
    want = tspecs.placement_bytes(dict(model.named_parameters()),
                                  placements, ctx)
    tsh.place_(model, ctx)
    assert tsh.placements_of(model) == placements
    for name, p in model.named_parameters():
        assert tuple(p.shape) == tspecs.local_shape(whole[name],
                                                    placements[name], ctx)
    assert sum(p.numel() * p.element_size()
               for p in model.parameters()) == want
    with pytest.raises(ValueError, match="placed already"):
        tsh.place_(model, ctx)


def test_shape_only_gathers_and_reduce_scatters():
    """On meta tensors: the block gather is one all-gather per dtype over
    the data group, whole shapes out; reduce_scatter keeps the rank's
    block; a partial all-gather's backward reduce-scatters; model_slice
    takes the rank's block and gathers in the backward."""
    ctx = tsh.shape_ctx((2, 4), ("data", "model"))
    cfg = tconfigs.reduced("glm4-9b")
    model = tlm.LM(cfg, device="meta")
    whole = {n: p.shape for n, p in model.named_parameters()}
    tsh.place_(model, ctx)
    block = model.blocks[0]
    tsh.reset_collectives()
    w = tsh.gather_params(block, ctx)
    assert tsh.collective_summary()["calls"] == {"all-gather": 1}
    for name, t in w.items():
        spec = tsh.spec_of(block.get_submodule(name.rpartition(".")[0]),
                           name.rpartition(".")[2])
        full = list(whole[f"blocks.0.{name}"])
        if "model" in spec:
            full[spec.index("model")] //= 4
        assert list(t.shape) == full, name
    x = torch.empty((8, 12), device="meta", requires_grad=True)
    tsh.reset_collectives()
    assert tsh.reduce_scatter(x, ctx, "model", 1).shape == (8, 3)
    y = tsh.all_gather(x, ctx, 0, partial=True)
    assert y.shape == (32, 12)
    y.sum().backward()
    z = tsh.model_slice(x, ctx, 1)
    assert z.shape == (8, 3)
    got = tsh.collective_summary()
    assert got["calls"] == {"reduce-scatter": 2, "all-gather": 1}
    assert got["by_op"]["reduce-scatter"] == (8 * 3 + 8 * 12) * 4


def test_one_rank_gathers_keep_values_layouts_and_gradients():
    """At one gloo rank every collective is a copy: the block gather
    returns each weight's values, a gather keeps its input's layout (a
    matmul picks its kernel by the strides), and the gradients come back
    onto the shards unchanged."""
    with tmesh.local_ctx(torch.device("cpu")) as ctx:
        cfg = tconfigs.reduced("olmoe-1b-7b")
        model = tlm.init(cfg, torch.Generator().manual_seed(0), "cpu",
                         ctx).trainable()
        block = model.blocks[1]
        w = tsh.gather_params(block, ctx)
        for name, p in block.named_parameters():
            assert torch.equal(w[name], p), name
        sum(t.float().square().sum() for t in w.values()).backward()
        for name, p in block.named_parameters():
            assert torch.equal(p.grad, 2 * p.detach()), name
        x = torch.arange(12.0).reshape(3, 4).t()
        y = tsh.all_gather(x, ctx, 0)
        assert torch.equal(y, x) and y.stride() == x.stride()
        assert torch.equal(tsh.reduce_scatter(x, ctx, "data", 1), x)


def test_leaf_shards_sum_over_the_groups_that_split_a_leaf():
    ctx = tsh.shape_ctx((2, 4), ("data", "model"))
    shards = tsh.LeafShards(ctx, {"a": (None, "data", "model"),
                                  "b": ("model",), "c": (), "d": ("data",)})
    assert [shards.leaf_group(k) for k in "abcd"] == ["world", "model",
                                                      None, "data"]
    assert shards.dim_group("a", -1) == "model"
    assert shards.dim_group("a", -2) == "data"
    assert shards.dim_group("c", -1) is None
    one = tsh.LeafShards(tsh.shape_ctx((1, 1), ("data", "model")),
                         {"a": ("data", "model")})
    assert one.leaf_group("a") is None      # a one-rank group splits nothing
