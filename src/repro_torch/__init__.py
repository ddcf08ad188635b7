"""FeDLRT in PyTorch for NVIDIA Hopper: the port of the JAX package
``repro``, which stays the reference.

This slice serves FeDLRT-factorized decoders factor-resident
(:mod:`repro_torch.api`, :mod:`repro_torch.serve`); every factorized
matmul runs the hand-written ``xus``/``avt`` CUDA kernels
(:mod:`repro_torch.kernels`). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
