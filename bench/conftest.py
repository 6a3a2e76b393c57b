"""Fixtures of the benchmark's CPU tests: the cells cut to a bandwidth the
CPU holds, run through the harness with the card's look skipped."""
import dataclasses

import pytest

from bench import cells


def small_cell(name: str, B: int = 8, **traffic):
    c = cells.load_cell(name)
    return dataclasses.replace(c, config={**c.config, "B": B},
                               traffic={**c.traffic, **traffic})


@pytest.fixture
def small():
    return small_cell


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
