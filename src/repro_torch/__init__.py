"""PyTorch/CUDA port of the streaming-RAG system (paper Algorithm 1).

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core/``, ``store/``, ``engine/``, ``kernels/``, ``serve/``) and
never imports it. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version, on the card it launches the hand-written CUDA kernel.
"""
