"""The plain reference that decides `correct`.

Plain Python over integers: no module here imports `jax`, the JAX package or
the port (`crypto3_zk_tpu_torch`); `zkbench/tests/test_zkbench_guard.py`
checks it. The reference recomputes what it needs from the inputs the
benchmark made and reads the program's proofs only to judge them.
"""
