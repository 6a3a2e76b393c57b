"""The port stands alone: importing repro_torch loads neither jax nor the
reference package, and no module of it (nor chip_smoke.py or tools/)
names them."""
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro\b(?!_torch)|import\s+repro\.|from\s+repro\.)",
    re.MULTILINE)


def test_import_loads_no_jax_or_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.plan\n"
        "import repro_torch.core, repro_torch.kernels, repro_torch.obs\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.launch\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.so3, repro_torch.so3.service\n"
        "import repro_torch.launch.serve_so3, repro_torch.configs.soft\n"
        "import repro_torch.core.parallel, repro_torch.launch.profile_so3\n"
        "import repro_torch.optim, repro_torch.data, repro_torch.ckpt\n"
        "import repro_torch.train, repro_torch.train.pipeline\n"
        "import repro_torch.launch.train, repro_torch.models.convert\n"
        "import repro_torch.models.sharding, repro_torch.launch.mesh\n"
        "import repro_torch.launch.specs, repro_torch.launch.flops\n"
        "import repro_torch.launch.dryrun\n"
        "assert callable(repro_torch.plan.warm_bandwidths)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert callable(repro_torch.plan)\n"
        "print('BAD', bad)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]
    + list((ROOT / "examples").glob("torch_*.py"))
    + list((ROOT / "tools").glob("*.py"))),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    hits = _FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_scan_catches_forbidden_imports():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from repro.core import soft")
    assert _FORBIDDEN.search("    import repro.plan")
    assert not _FORBIDDEN.search("from repro_torch.core import soft")
    assert not _FORBIDDEN.search("import repro_torch")
