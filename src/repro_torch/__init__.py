"""PyTorch + CUDA port of the federated-optimization system, for NVIDIA
Hopper (H100).

The JAX package ``repro`` is the reference; this package imports nothing of
it and nothing of JAX.  The main path is the paper's Fig. 2 experiment:
``data.generate`` → ``core.build_problem`` → ``core.make_solver("fsvrg")``
→ ``core.Trainer.fit``, with the server aggregation and FSVRG's local step
as hand-written CUDA kernels (``kernels/``).  Entry points run on the CUDA
card unless called with ``device="cpu"``.
"""
