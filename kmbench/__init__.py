"""kmbench: the benchmark of keymorph_tpu_torch (the PyTorch and CUDA port
of keymorph_tpu) on one NVIDIA H100. ``python3 -m kmbench.run --help``;
``kmbench/README.md`` says how to run a cell and how to add one."""
