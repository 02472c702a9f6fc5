"""The benchmark of tartangan_torch, the PyTorch and CUDA port: three
bfloat16 training cells on one H100, driven by the data files beside this
file. ``python3 portbench/run.py --workload W --seed N --seconds S --trace
0|1`` runs one cell once (``run.py``)."""
