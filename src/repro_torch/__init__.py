"""repro_torch: the PyTorch / CUDA port of the SchalaDB reproduction.

A package of its own beside ``repro`` (the JAX reference), importing
nothing of it: the numpy control plane it needs is copied under
``repro_torch.core``. Entry points run on the CUDA card unless the caller
passes ``device="cpu"``; on a card, the work-queue claim, prefill attention
and decode attention run hand-written Hopper kernels
(``repro_torch/csrc``), on the CPU their plain PyTorch versions.
"""
