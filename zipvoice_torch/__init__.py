"""ZipVoice in PyTorch for NVIDIA Hopper GPUs.

A port of ``zipvoice_tpu`` (the JAX package, which stays the numerical
reference).  Module paths mirror the JAX package; every TPU kernel of the
JAX package (the rel-pos attention weights and their trainable
forward/backward pair, the fused weights + NonlinAttention and application
kernels, the depthwise conv and its backward) is a hand-written CUDA kernel
under ``csrc/``, built on first use into ``build/kernels``.  The text and
wav front end (``frontend/``) and the ``bin/infer_zipvoice`` CLI are the
port's own copies of the JAX package's.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"`` (the CLI ``--platform cpu``).
"""
