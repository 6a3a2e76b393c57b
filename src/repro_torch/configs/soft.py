"""The paper's own workload: SO(3) FFT configurations (the port's copy of
``repro.configs.soft``).

Bandwidths match the paper's benchmark (Sec. 4): B in {32, 64, 128, 256,
512}.  B = 512 is the accuracy- and memory-critical case the paper runs
first; the port runs it in f64 on one card (``repro_torch.plan(512)``).
"""
import dataclasses

PAPER_BANDWIDTHS = (32, 64, 128, 256, 512)


@dataclasses.dataclass(frozen=True)
class SoftConfig:
    """One row: its name and bandwidth.  The precision and the lane width
    are the plan's (``repro_torch.plan(B)``: f64, V by its rule)."""
    name: str
    bandwidth: int


CONFIGS = {f"soft_b{B}": SoftConfig(name=f"soft_b{B}", bandwidth=B)
           for B in PAPER_BANDWIDTHS}
