"""PyTorch/CUDA port of horovod_tpu (see horovod_tpu_torch/__init__.py)."""
