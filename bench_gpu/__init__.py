"""Benchmark of the PyTorch and CUDA port (`spades_tpu_torch`) on an NVIDIA
H100: whole CLI invocations on generated samples, driven by the data files
of this folder.  `python3 bench_gpu/run.py --help` says how to run a cell."""
