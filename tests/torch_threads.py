"""Imported by every `tests/test_torch_*.py`. The suite's worker processes
share the machine's cores, and torch would start a thread per core in each
of them: one torch thread a worker (the setting holds for the process)."""
import torch

torch.set_num_threads(1)
