"""The port's kernels: CUDA C++ for Hopper (``csrc/``), built by ``_build``,
wrapped in ``scaled_aggregate``, ``fsvrg_update``, ``fedavg_update``,
``dane_update``, ``cocoa_sdca``, ``robust_aggregate``, ``wkv6`` and
``segment_sum``, reached through
``ops``; ``ref`` holds their plain PyTorch versions."""
