"""PyTorch/CUDA port of the RELIEF reproduction (``src/repro`` is the JAX
reference it is held against).

The package mirrors ``repro``'s layout (core/, data/, sim/, models/, optim/,
dist/, kernels/, launch/) so each module's counterpart sits at the same path.
It imports torch and numpy, never jax and never ``repro``. Parameters are
nested ``dict``s of tensors walked in sorted key order (``tree.py``), which is
the order JAX flattens them in, so leaf paths and group ids match the
reference one for one.

Entry points take ``device=None``, meaning the CUDA card; without one they
raise rather than fall back to the CPU. Tests pass ``device="cpu"``, where
every kernel wrapper uses its plain PyTorch version.
"""
