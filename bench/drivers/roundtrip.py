"""Closed-loop SO(3) transforms: one caller, each step an inverse of a
coefficient batch, synchronized, then a forward of the grids it returned,
synchronized (the paper's Table-1 protocol).

Traffic keys: ``batch`` (transforms a call), ``inputs`` (batches made at
set-up and used in turn), ``calls`` ("batch": ``inverse_batch`` /
``forward_batch``; "single": ``inverse`` / ``forward`` of one set),
``trace_seconds`` (the traced window), ``limits`` (of the numbers
compared).

Metrics: ``inverse_ms`` / ``forward_ms``, the sum over the window of each
synchronized call's host time over the transforms it made.

Correctness: the last outputs of each input batch in full, both
directions, each against the reference run on that direction's own
input; and every step's outputs by a digest (the grids contracted with
seeded vectors over alpha and gamma, the coefficients over m and m')
against the reference's digest of the same batch.
"""
from __future__ import annotations

import gc
import math
import time

import torch

from bench import reference


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The system under test: ``repro_torch.plan(B, ...)``'s executors,
    taking and giving (n, ...) stacks."""

    def __init__(self, cell, device):
        import repro_torch
        cfg = cell.config
        self.plan = repro_torch.plan(int(cfg["B"]), getattr(torch, cfg["dtype"]),
                                     device=device, **cfg.get("plan", {}))
        self.batch = cell.traffic["calls"] == "batch"

    def inverse(self, x):
        return self.plan.inverse_batch(x) if self.batch \
            else self.plan.inverse(x[0])[None]

    def forward(self, y):
        return self.plan.forward_batch(y) if self.batch \
            else self.plan.forward(y[0])[None]

    def release(self):
        import repro_torch
        self.plan = None
        repro_torch.plan.clear_cache()


class ReferenceProgram:
    """The control: the reference put in the program's place, in the
    precision one below the configuration's."""

    def __init__(self, cell, device, dtype=torch.float32):
        self.dtype = dtype
        self.cdt = torch.complex128 if cell.config["dtype"] == "float64" \
            else torch.complex64

    def inverse(self, x):
        return reference.so3_inverse(x, dtype=self.dtype).to(self.cdt)

    def forward(self, y):
        return reference.so3_forward(y, dtype=self.dtype).to(self.cdt)

    def release(self):
        pass


def random_coeffs(B, n, gen, device, cdtype):
    """Re, Im ~ U[-1, 1] on the valid cells, zero elsewhere."""
    x = torch.rand((n, B, 2 * B - 1, 2 * B - 1), generator=gen,
                   device=device, dtype=cdtype)
    x.mul_(2).sub_(1 + 1j)
    x.masked_fill_(~reference.valid_mask(B, device), 0)
    return x


class Driver:
    def __init__(self, cell, seed: int, device, program=None):
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.make_program = program or Program
        self.B = int(cell.config["B"])
        self.rdt = getattr(torch, cell.config["dtype"])
        self.cdt = torch.complex128 if self.rdt == torch.float64 \
            else torch.complex64
        self.n = int(cell.traffic["batch"])
        self.parts: dict[str, float] = {}

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        t0 = time.perf_counter()
        self.program = self.make_program(self.cell, self.device)
        t1 = time.perf_counter()
        gen = torch.Generator(self.device).manual_seed(self.seed)
        self.inputs = [random_coeffs(self.B, self.n, gen, self.device,
                                     self.cdt)
                       for _ in range(int(self.cell.traffic["inputs"]))]
        B, S = self.B, 2 * self.B - 1

        def vec(k):
            return (2 * torch.rand(k, generator=gen, device=self.device,
                                   dtype=self.rdt) - 1).to(self.cdt)
        self.r = {"alpha": vec(2 * B), "gamma": vec(2 * B), "m": vec(S),
                  "mp": vec(S)}
        sync(self.device)
        t2 = time.perf_counter()
        y = self.program.inverse(self.inputs[0])     # the warm step
        z = self.program.forward(y)
        self.digest_grid(y)
        self.digest_coeffs(z)
        del y, z
        sync(self.device)
        self.parts = {"program_s": t1 - t0, "inputs_s": t2 - t1,
                      "warm_step_s": time.perf_counter() - t2}

    def digest_grid(self, y):
        """(n, 2B, 2B, 2B) -> (n, 2B): contracted over alpha and gamma."""
        return torch.einsum("nab,a->nb", y @ self.r["gamma"],
                            self.r["alpha"])

    def digest_coeffs(self, z):
        """(n, B, 2B-1, 2B-1) -> (n, B): contracted over m and m'."""
        return torch.einsum("nlm,m->nl", z @ self.r["mp"], self.r["m"])

    # -- the measured window --------------------------------------------
    def window(self, seconds: float, mark) -> None:
        self.kept: dict[int, tuple] = {}
        self.digests: list[tuple] = []
        self.time = {"inverse": 0.0, "forward": 0.0}
        self.steps = 0
        end = time.perf_counter() + seconds
        dev = self.device
        while self.steps == 0 or time.perf_counter() < end:
            k = self.steps % len(self.inputs)
            self.kept.pop(k, None)
            with mark("inverse"):
                t0 = time.perf_counter()
                y = self.program.inverse(self.inputs[k])
                sync(dev)
                t1 = time.perf_counter()
            with mark("forward"):
                z = self.program.forward(y)
                sync(dev)
                t2 = time.perf_counter()
            self.time["inverse"] += t1 - t0
            self.time["forward"] += t2 - t1
            self.digests.append((k, self.digest_grid(y),
                                 self.digest_coeffs(z)))
            sync(dev)
            self.kept[k] = (y, z)
            del y, z
            self.steps += 1

    def host(self) -> dict:
        n = self.steps * self.n
        return {kind: {"seconds": s, "transforms": n}
                for kind, s in self.time.items()}

    def end_to_end(self) -> dict:
        n = self.steps * self.n
        return {"inverse_ms": 1e3 * self.time["inverse"] / n,
                "forward_ms": 1e3 * self.time["forward"] / n}

    def attempted_failed(self) -> tuple[int, int]:
        return 2 * self.steps * self.n, 0

    def release(self) -> None:
        self.program.release()
        self.program = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness ----------------------------------------------------
    def judge(self) -> list[tuple[str, float, float]]:
        lim = self.cell.traffic["limits"]
        gap = {"inverse_err": [0.0, 0.0], "forward_err": [0.0, 0.0],
               "inverse_digest_err": [0.0, 0.0],
               "forward_digest_err": [0.0, 0.0]}

        def note(key, diff, scale):
            g = gap[key]
            g[0] = max(g[0], float(diff))
            g[1] = max(g[1], float(scale))
        for k, (y, z) in sorted(self.kept.items()):
            ref_dig = torch.zeros((self.n, 2 * self.B), dtype=self.cdt,
                                  device=self.device)

            def on_grid(j0, j1, g, y=y, ref_dig=ref_dig):
                note("inverse_err", (y[:, :, j0:j1] - g).abs().max(),
                     g.abs().max())
                ref_dig[:, j0:j1] = torch.einsum(
                    "nab,a->nb", g @ self.r["gamma"], self.r["alpha"])
            fwd = reference.so3_blocks(
                self.B, coeffs=self.inputs[k],
                grid_block=lambda j0, j1, y=y: y[:, :, j0:j1],
                on_grid=on_grid, dtype=self.rdt, device=self.device)
            for l0 in range(0, self.B, 32):        # a few GB at a time
                note("forward_err", (z[:, l0:l0 + 32] - fwd[:, l0:l0 + 32])
                     .abs().max(), fwd[:, l0:l0 + 32].abs().max())
            ref_fdig = self.digest_coeffs(fwd)
            del fwd
            for kk, dg, dc in self.digests:
                if kk == k:
                    note("inverse_digest_err", (dg - ref_dig).abs().max(),
                         ref_dig.abs().max())
                    note("forward_digest_err", (dc - ref_fdig).abs().max(),
                         ref_fdig.abs().max())
        out = []
        for key, (diff, scale) in gap.items():
            val = diff / scale if scale > 0 else math.inf
            out.append((key, val, float(lim[key])))
        return out
