"""The port's training runtime around the step (repro_torch.data, ckpt,
train.Trainer, train.straggler) against the reference's (repro.data,
repro.ckpt) on identical inputs, and the reference's own tests of it
(tests/test_train_runtime.py, tests/test_fault_tolerance.py) ported:
batches equal byte for byte, checkpoints read by either package (bf16
included), crash restore, preemption replay (rel 1e-5, the reference's),
straggler policy."""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import ckpt as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.data import DataConfig as JData, SyntheticLM as JSynth  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import OptConfig as JOpt, init_opt as jinit  # noqa: E402

from repro_torch import ckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.ckpt.checkpoint import flatten_paths  # noqa: E402
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.optim import OptConfig, init_opt  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.train.straggler import (StragglerPolicy,  # noqa: E402
                                         WorkerState, largest_mesh)


def _configs(dtype="float32"):
    """The reduced smollm-135m of each package, in ``dtype``."""
    over = {} if dtype == "float32" else dict(param_dtype=dtype,
                                              compute_dtype=dtype)
    return (dataclasses.replace(jconfigs.reduced("smollm-135m"), **over),
            dataclasses.replace(tconfigs.reduced("smollm-135m"), **over))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: its tensors are small, and beside
    other test workers a thread pool mostly waits for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(vocab_size=1000, seq_len=64, global_batch=8, num_shards=4, seed=3),
    dict(vocab_size=49152, seq_len=257, global_batch=2, mean_doc_len=40),
    dict(vocab_size=128, seq_len=32, global_batch=2)])
def test_batches_equal_reference_bytes(cfg):
    for shard in range(cfg.get("num_shards", 1)):
        for step in (0, 1, 17):
            a = SyntheticLM(DataConfig(**cfg), shard).batch_at(step)
            b = JSynth(JData(**cfg), shard).batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and \
                    a[k].tobytes() == b[k].tobytes(), (shard, step, k)


def test_data_deterministic_and_disjoint():
    cfg = DataConfig(vocab_size=1000, seq_len=64, global_batch=8,
                     num_shards=4, seed=3)
    a = SyntheticLM(cfg, shard=1).batch_at(7)
    b = SyntheticLM(cfg, shard=1).batch_at(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = SyntheticLM(cfg, shard=2).batch_at(7)
    assert not np.array_equal(a["tokens"], c["tokens"])
    batch = SyntheticLM(cfg, shard=0).batch_at(0)
    assert batch["tokens"].shape == (2, 64)
    np.testing.assert_array_equal(batch["tokens"][:, 1:],
                                  batch["labels"][:, :-1])


def test_prefetcher_orders_batches():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=2)
    pf = Prefetcher(SyntheticLM(cfg), start_step=5, depth=2)
    try:
        assert [pf.get()[0] for _ in range(4)] == [5, 6, 7, 8]
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def tree_example():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.tensor([1, 2], dtype=torch.int32)},
            "lst": [torch.ones(2, dtype=torch.bfloat16)]}


def _assert_same(a, b):
    fa, fb = flatten_paths(a), flatten_paths(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_checkpoint_roundtrip(tmp_path):
    t = tree_example()
    ckpt.save_checkpoint(str(tmp_path), 3, t, meta={"x": 1})
    step, t2, meta = ckpt.load_checkpoint(str(tmp_path), t)
    assert step == 3 and meta == {"x": 1}
    _assert_same(t2, t)


def test_checkpoint_detects_corruption(tmp_path):
    t = tree_example()
    path = ckpt.save_checkpoint(str(tmp_path), 1, t)
    npz = os.path.join(path, "arrays.npz")
    raw = bytearray(open(npz, "rb").read())
    raw[-20] ^= 0xFF
    open(npz, "wb").write(bytes(raw))
    with pytest.raises(Exception):
        ckpt.load_checkpoint(str(tmp_path), t)


def test_checkpoint_gc_and_latest(tmp_path):
    t = tree_example()
    for s in (1, 5, 9):
        ckpt.save_checkpoint(str(tmp_path), s, t)
    assert ckpt.latest_step(str(tmp_path)) == 9
    ckpt.checkpoint.gc_checkpoints(str(tmp_path), keep_n=2)
    assert ckpt.latest_step(str(tmp_path)) == 9
    assert sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)) == \
        [5, 9]


def test_async_checkpointer(tmp_path):
    t = tree_example()
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep_n=2)
    for s in range(4):
        ac.save(s, t)
    t["w"].add_(1.0)        # after save(): the snapshot must not see it
    ac.wait()
    assert ckpt.latest_step(str(tmp_path)) == 3
    _, t2, _ = ckpt.load_checkpoint(str(tmp_path), t)
    assert float(t2["w"][0, 0]) == 0.0


def test_restore_to_device_checks_shapes(tmp_path):
    t = tree_example()
    ckpt.save_checkpoint(str(tmp_path), 0, t)
    step, placed, _ = ckpt.restore_to_device(str(tmp_path), t, "cpu")
    _assert_same(placed, t)
    bad = dict(t, w=torch.zeros(3, 2))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_to_device(str(tmp_path), bad, "cpu")


def _training_trees(dtype):
    """The reference's (params, AdamW state) of the reduced smollm in
    ``dtype``, and the port's same state."""
    cj, ct = _configs(dtype)
    params = jlm.init(cj, jax.random.key(4))
    jtree = (params, jinit(JOpt(), params))
    model = convert.params_from_numpy(ct, jax.tree.map(np.asarray, params),
                                      "cpu")
    stacks = convert.stacks(model)
    return jtree, (stacks, init_opt(OptConfig(), stacks))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_read(dtype, tmp_path):
    """A checkpoint of either package loads in the other: the same keys
    (the reference's paths), dtype strings and CRCs; bfloat16 as its
    uint16 bits."""
    jtree, ttree = _training_trees(dtype)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 2, jtree, meta={"a": 1})
    ckpt.save_checkpoint(str(tmp_path / "port"), 2, ttree, meta={"a": 1})
    man = [json.loads((tmp_path / d / "step_00000002" / "manifest.json")
                      .read_text()) for d in ("ref", "port")]
    assert man[0]["leaves"] == man[1]["leaves"]
    step, got, meta = ckpt.load_checkpoint(str(tmp_path / "ref"), ttree)
    assert step == 2 and meta == {"a": 1}
    _assert_same(got, ttree)
    step, back, _ = jckpt.load_checkpoint(str(tmp_path / "port"),
                                          jax.eval_shape(lambda: jtree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype and np.array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# fault tolerance (tests/test_fault_tolerance.py, ported)
# ---------------------------------------------------------------------------

def tiny_setup(tmp_path, steps=8, mean_doc_len=256, **kw):
    cfg = dataclasses.replace(tconfigs.reduced("smollm-135m"), num_layers=2,
                              d_model=64, num_heads=2, num_kv_heads=1,
                              head_dim=32, d_ff=128, vocab_size=128)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2,
                      mean_doc_len=mean_doc_len)
    tcfg = TrainConfig(steps=steps, ckpt_every=2, ckpt_dir=str(tmp_path),
                       keep_ckpts=3,
                       opt=OptConfig(peak_lr=1e-3, warmup_steps=2,
                                     decay_steps=100), **kw)
    return cfg, tcfg, SyntheticLM(dcfg)


def test_trainer_runs_and_loss_decreases(tmp_path):
    """At the reference's settings the stream is uniform over 127 tokens
    with an EOS every ~256: the loss starts at its floor (~ln 128) and
    only moves with the batches.  Documents of ~4 tokens make EOS a
    fifth of the stream, which 12 steps learn."""
    cfg, tcfg, data = tiny_setup(tmp_path, steps=12, mean_doc_len=4)
    tr = Trainer(cfg, tcfg, data, device="cpu")
    tr.run()
    losses = [h["loss"] for h in tr.history if "loss" in h]
    assert len(losses) == 12
    assert losses[-1] < losses[0]


def test_trainer_recovers_from_crash(tmp_path):
    """A simulated node failure at step 5 restores from the step-4
    checkpoint and completes; the history shows the restart."""
    cfg, tcfg, data = tiny_setup(tmp_path, steps=8)
    crashed = {"done": False}

    def fail_hook(step):
        if step == 5 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("simulated node failure")

    tr = Trainer(cfg, tcfg, data, device="cpu")
    tr.run(fail_hook=fail_hook)
    events = [h for h in tr.history if "event" in h]
    assert len(events) == 1 and "simulated node failure" in events[0]["event"]
    assert [h["step"] for h in tr.history if "loss" in h] == list(range(8))


def test_preemption_replay_is_deterministic(tmp_path):
    """Kill the job before step 6, start a new trainer from the
    checkpoint: losses on the replayed steps match an uninterrupted run."""
    cfg, tcfg, data = tiny_setup(tmp_path, steps=10)

    def preempt(step):
        if step == 6:
            raise KeyboardInterrupt  # not caught by the trainer: hard kill

    tr1 = Trainer(cfg, tcfg, data, device="cpu")
    with pytest.raises(KeyboardInterrupt):
        tr1.run(fail_hook=preempt)
    tr1.ckpt.wait()
    tr2 = Trainer(cfg, tcfg, data, device="cpu")
    tr2.run()
    l2 = {h["step"]: h["loss"] for h in tr2.history if "loss" in h}
    assert min(l2) == 5
    shutil.rmtree(tmp_path)
    tr3 = Trainer(cfg, tcfg, data, device="cpu")
    tr3.run()
    l3 = {h["step"]: h["loss"] for h in tr3.history if "loss" in h}
    for s in l2:
        assert l2[s] == pytest.approx(l3[s], rel=1e-5), s


def test_non_finite_loss_restores(tmp_path, monkeypatch):
    """A NaN loss is a FloatingPointError: the trainer restores and
    replays, as on a crash."""
    cfg, tcfg, data = tiny_setup(tmp_path, steps=6)
    tr = Trainer(cfg, tcfg, data, device="cpu")
    real = tr.step_fn
    seen = {"done": False}

    def step_fn(model, st, err, batch, step):
        out = real(model, st, err, batch, step)
        if step == 3 and not seen["done"]:
            seen["done"] = True
            out[3]["loss"] = torch.tensor(float("nan"))
        return out

    tr.step_fn = step_fn
    tr.run()
    events = [h for h in tr.history if "event" in h]
    assert len(events) == 1 and "non-finite" in events[0]["event"]
    assert [h["step"] for h in tr.history if "loss" in h] == list(range(6))


def test_trainer_needs_a_device_or_a_card(tmp_path):
    cfg, tcfg, data = tiny_setup(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, tcfg, data)


def test_straggler_suspect_and_recover():
    pol = StragglerPolicy(4, suspect_after=10, evict_after=50, lag_steps=5)
    for w in range(4):
        pol.note_heartbeat(w, step=100, now=0.0)
    for w in (0, 1, 3):
        pol.note_heartbeat(w, step=110, now=20.0)
    ev = pol.poll(now=20.0)
    assert [e.kind for e in ev] == ["suspect"] and ev[0].worker == 2
    pol.note_heartbeat(2, step=111, now=21.0)
    assert pol.workers[2].state is WorkerState.HEALTHY
    assert pol.poll(now=22.0) == []


def test_straggler_evict_and_elastic_restart():
    pol = StragglerPolicy(4, suspect_after=10, evict_after=50, lag_steps=5)
    for w in range(4):
        pol.note_heartbeat(w, step=100, now=0.0)
    for t in (20.0, 80.0):
        for w in (0, 1, 3):
            pol.note_heartbeat(w, step=100 + int(t), now=t)
        events = pol.poll(now=t)
    kinds = [e.kind for e in events]
    assert "evict" in kinds and "elastic_restart" in kinds
    restart = [e for e in events if e.kind == "elastic_restart"][0]
    assert restart.detail["survivors"] == 3
    assert pol.alive() == [0, 1, 3]


def test_straggler_lag_detection():
    pol = StragglerPolicy(3, suspect_after=1e9, evict_after=1e9, lag_steps=10)
    pol.note_heartbeat(0, step=100, now=1.0)
    pol.note_heartbeat(1, step=100, now=1.0)
    pol.note_heartbeat(2, step=80, now=1.0)
    ev = pol.poll(now=1.0)
    assert [e.kind for e in ev] == ["suspect"] and ev[0].worker == 2


def test_largest_mesh():
    assert largest_mesh(128, 4) == (32, 16)
    d, m = largest_mesh(96, 4)
    assert d * m <= 384
    assert largest_mesh(1, 4) == (1, 4)
