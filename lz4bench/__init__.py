"""The benchmark of the PyTorch and CUDA port (``divortio_lz4_tpu_torch``):
``python3 -m lz4bench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>``. See ``run.py``."""
