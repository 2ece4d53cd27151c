"""PyTorch/CUDA port of the ``repro`` package.

Module names mirror ``src/repro/`` so each piece has a findable twin.
The package imports ``torch``, ``numpy`` and the standard library only:
never ``jax`` and nothing of ``repro``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; the hand-written kernels
(``repro_torch.kernels``) are the model path on CUDA tensors, and their
plain PyTorch versions run only for CPU tensors.
"""
