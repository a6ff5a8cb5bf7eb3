"""The benchmark of the PyTorch/CUDA port (`python benchmark/run.py`)."""
