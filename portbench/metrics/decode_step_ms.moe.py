"""Mean of the engine's own decode-step times in the window, in ms, in the
MoE cell: ``decode_step_ms.serve``'s reading, loaded from its file."""
from pathlib import Path

from harness import load_module

_serve = load_module(Path(__file__).with_name("decode_step_ms.serve.py"),
                     "portbench_metric_decode_step_ms_serve")


def read(obs):
    return _serve.read(obs)
