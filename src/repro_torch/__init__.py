"""PyTorch/CUDA port of ``repro``: tree-structured GGM learning under
communication constraints, with hand-written Hopper kernels on the
encode -> Gram path, and the dense LM serving path (flash-prefill and
flash-decode kernels).

The package mirrors ``repro``'s layout module for module and never
imports it (nor JAX). Entry points run on the device of the tensors they
are given; host input (numpy, or no tensor at all) goes to ``cuda``
unless the caller passes ``device="cpu"``, and without CUDA they raise
instead of carrying on quietly on the CPU.
"""
