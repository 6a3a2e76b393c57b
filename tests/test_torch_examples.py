"""The port's examples run end to end on the CPU (subprocess; small
settings), as tests/test_examples.py runs the reference's: the same
"OK" / "rotation recovered" / "loss decreased" lines; and the launchers
(serve, train) in process."""
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run_example(script, *args, timeout=300, threads=None):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
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


def test_torch_train_lm_tiny(tmp_path):
    """The tiny preset for 60 steps with its defaults, as
    tests/test_examples.py runs the reference's (a fresh checkpoint
    directory: the trainer resumes from one it finds).  One thread: the
    model's matmuls are small, and beside other test workers a thread
    pool only waits for cores (~20 s alone)."""
    out = run_example("torch_train_lm.py", "--preset", "tiny", "--steps",
                      "60", "--ckpt-dir", str(tmp_path / "ckpt"), threads=1)
    assert "OK: loss decreased" in out and "on cpu" in out


def test_train_launcher_reduced(tmp_path, capsys):
    from repro_torch.launch import train
    tr = train.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                     "--steps", "4", "--seq-len", "64", "--global-batch",
                     "4", "--microbatch", "2", "--ckpt-dir",
                     str(tmp_path / "ckpt"), "--ckpt-every", "2",
                     "--log-every", "1"])
    out = capsys.readouterr().out
    assert "final: step 3" in out and "on cpu" in out
    assert [h["step"] for h in tr.history] == [0, 1, 2, 3]
    assert sorted(os.listdir(tmp_path / "ckpt")) == \
        ["step_00000000", "step_00000002", "step_00000003"]
