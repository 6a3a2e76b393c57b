"""What decides ``correct``: the control (the reference one precision down
in the program's place) and planted faults of the timed path must come
out not correct, and the program itself correct.  The harness runs with
the card's look skipped, on the CPU at a bandwidth it holds."""
import pytest
import torch

from bench import run
from bench.drivers import roundtrip

SEED = 2 ** 31 + 11


def _run(cell, program=None, seconds=0.25):
    return run.run_cell(cell, SEED, seconds, False, "cpu", program=program)


@pytest.mark.parametrize("name", ["soft-b128-f64.roundtrip",
                                  "soft-b512-f64.roundtrip"])
def test_program_correct_control_not(name, small):
    cell = small(name, B=8)
    assert _run(cell)["correct"]
    res = _run(cell, roundtrip.ReferenceProgram, seconds=0.05)
    assert not res["correct"]
    assert all(c["value"] > c["limit"] for c in res["checks"].values())


class Stale(roundtrip.Program):
    """A step that returns its state unchanged: the forward's first
    output, every time."""

    def forward(self, y):
        if not hasattr(self, "first"):
            self.first = super().forward(y)
        return self.first.clone()


class HalfBatch(roundtrip.Program):
    """Half of the batch left out, the mean of the rest in its place."""

    def inverse(self, x):
        h = (x.shape[0] + 1) // 2
        y = super().inverse(x[:h])
        return torch.cat([y, y.mean(0, keepdim=True).expand(
            x.shape[0] - h, *y.shape[1:])])


class Altered(roundtrip.Program):
    """One answer altered where it is produced, on one call of the window
    (not the last: only the step's digest sees it)."""

    calls = 0

    def inverse(self, x):
        y = super().inverse(x)
        Altered.calls += 1
        if Altered.calls == 3:
            y[0, 1, 2, 3] += 1e-6 * y.abs().max()
        return y


@pytest.mark.parametrize("fault", [Stale, HalfBatch, Altered])
def test_roundtrip_faults_are_not_correct(fault, small):
    Altered.calls = 0
    cell = small("soft-b128-f64.roundtrip", B=8)
    res = _run(cell, fault)
    assert not res["correct"], res["checks"]
