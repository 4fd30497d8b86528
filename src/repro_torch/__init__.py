"""PyTorch and CUDA port of the TAG reproduction (``repro``), for NVIDIA Hopper.

The package imports ``torch`` and nothing of ``repro`` or JAX: what it needs
of the reference package (configs, layer definitions) it keeps as its own
copy under the same module names, so each counterpart is easy to find.
Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``.
"""
