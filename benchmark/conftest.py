"""Shared pieces of the benchmark's CPU tests: cells cut to a tiny size."""

import os
import sys

import pytest
import torch

# the checkout's root: the benchmark and the program are its packages
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny():
    """``tiny(name)`` -> the cell ``name`` at 128 x 128, 4 frames a GOF."""
    from benchmark import cells

    def make(name: str):
        cell = cells.load(name)
        cell.config["atlas"].update(width=128, height=128, frames=4)
        return cell

    return make
