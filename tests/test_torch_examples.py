"""The port's examples run end to end on the CPU (subprocess; small
settings), as tests/test_examples.py runs the reference's: the same
"OK" / "rotation recovered" lines."""
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run_example(script, *args, timeout=300):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *args,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=timeout, cwd=str(ROOT),
        env=env)
    assert proc.returncode == 0, (
        f"--- stdout ---\n{proc.stdout[-3000:]}\n"
        f"--- stderr ---\n{proc.stderr[-2000:]}")
    return proc.stdout


def test_torch_quickstart():
    out = run_example("torch_quickstart.py", "--bandwidth", "8")
    assert "OK" in out and "on cpu" in out


def test_torch_rotational_matching():
    out = run_example("torch_rotational_matching.py", "--bandwidth", "12")
    assert "rotation recovered" in out


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-9b",
                                  "musicgen-medium", "qwen2-vl-7b",
                                  "llama4-maverick-400b-a17b"])
def test_torch_serve_lm(arch):
    out = run_example("torch_serve_lm.py", "--arch", arch, "--tokens", "8",
                      "--prompt-len", "16")
    assert "OK" in out and "on cpu" in out


def test_serve_launcher_refuses_embedding_archs():
    from repro_torch.launch import serve
    for arch in ("musicgen-medium", "qwen2-vl-7b"):
        with pytest.raises(SystemExit, match="torch_serve_lm.py"):
            serve.main(["--arch", arch, "--reduced", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-3b",
                                  "olmoe-1b-7b"])
def test_serve_launcher_takes_token_archs(arch, capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12", "--tokens", "3"])
    assert out.shape == (2, 3)
    assert "generated 2x3 tokens" in capsys.readouterr().out
