"""The benchmark of the PyTorch + CUDA port (``synergynet_tpu_torch``):
``python3 perfbench/run.py --workload <cell> ...``; see ``run.py``."""
