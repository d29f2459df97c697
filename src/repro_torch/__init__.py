"""PyTorch/CUDA port of the ARMS reproduction (``src/repro`` is the JAX
reference it is held to).

The package mirrors ``repro``'s module layout.  It imports ``torch`` and
numpy only — never ``jax`` and never a module of ``repro``; what it needs
from the reference's JAX-free modules it keeps as its own copy.  Public
entry points take ``device=None``, which means the CUDA card; the CPU is
used only when a caller asks for it (``device="cpu"``), as the parity
tests do.
"""
