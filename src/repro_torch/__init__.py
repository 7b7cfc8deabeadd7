"""PyTorch/CUDA port of the ``repro`` model substrate for one NVIDIA H100.

Same layout and names as ``repro``: ``configs``, ``kernels`` (CUDA C++
kernels written for ``sm_90a`` beside their plain PyTorch versions),
``models``, ``serve`` and ``launch``. The package imports ``torch`` and
never JAX or ``repro``. Entry points run on the card unless the caller
asks for the CPU.
"""
