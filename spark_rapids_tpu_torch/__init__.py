"""PyTorch / CUDA port of spark_rapids_tpu for one NVIDIA H100.

The package mirrors the module paths of ``spark_rapids_tpu`` and imports
nothing of it, nor of JAX.  Device kernels are hand-written CUDA in
``csrc/``, built at first use; each has a plain PyTorch version that runs
on CPU tensors.
"""
