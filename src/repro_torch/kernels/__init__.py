"""Hand-written Hopper kernels of the port.

Each kernel package has:
  ref.py    — the plain PyTorch version (the CPU path and the on-card yardstick)
  kernel.py — the CUDA kernel's wrapper (built from ``csrc/`` at first use)
  ops.py    — the dispatching entry point: CPU tensors → ref, CUDA → kernel
"""
