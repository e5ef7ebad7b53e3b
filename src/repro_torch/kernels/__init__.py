"""The port's kernels: CUDA C++ for Hopper (``csrc/``), built by ``_build``,
wrapped in ``scaled_aggregate``, ``fsvrg_update``, ``fedavg_update``,
``dane_update`` and ``cocoa_sdca``, reached through
``ops``; ``ref`` holds their plain PyTorch versions."""
