"""Share of the profiled decode steps in which no operation ran on the
card, in the MoE cell: ``device_idle_share.serve``'s reading, loaded from
its file."""
from pathlib import Path

from harness import load_module

_serve = load_module(Path(__file__).with_name("device_idle_share.serve.py"),
                     "portbench_metric_device_idle_share_serve")


def read(obs):
    return _serve.read(obs)
