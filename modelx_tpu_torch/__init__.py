"""PyTorch + CUDA port of modelx-tpu's serving sidecar, for NVIDIA Hopper.

The JAX package (``modelx_tpu``) is the reference: every module here keeps
its counterpart's module and function names so a reader can find each
twin. This package imports torch, numpy and the standard library only —
never jax, ml_dtypes or anything under ``modelx_tpu``.
"""
