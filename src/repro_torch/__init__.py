"""PyTorch port of the hext simulator (``repro.core.hext``) and its kernels.

The JAX package ``repro`` is the reference; this package imports neither
``jax`` nor anything of ``repro``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
