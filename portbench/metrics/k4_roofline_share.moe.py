"""Kernel 4's share of its roofline in the profiled decode steps, at the
MoE cell's widths: ``k4_roofline_share.serve``'s reading, loaded from its
file."""
from pathlib import Path

from harness import load_module

_serve = load_module(Path(__file__).with_name("k4_roofline_share.serve.py"),
                     "portbench_metric_k4_roofline_share_serve")


def read(obs):
    return _serve.read(obs)
