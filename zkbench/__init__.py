"""The benchmark of the PyTorch and CUDA port (`crypto3_zk_tpu_torch`): a
prover service under closed-loop traffic, one cell a run. See README.md."""
