"""The port's kernels: CUDA C++ for Hopper (``csrc/``), built by ``_build``,
wrapped in ``scaled_aggregate`` and ``fsvrg_update``, reached through
``ops``; ``ref`` holds their plain PyTorch versions."""
