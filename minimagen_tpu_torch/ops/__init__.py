"""Tensor ops of the port: diffusion math, attention, GroupNorm, resizing,
the conv stem, and the CUDA kernels behind them (``kernels.py``)."""
