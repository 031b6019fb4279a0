"""PyTorch/CUDA port of the unetdc-tpu droplet segmentation and
quantification framework.

The JAX package `unetdc_tpu` is the reference; this package reproduces its
flagship batch quantifier (`cli/quantify_droplets_batch.py` ->
`pipelines/quantify_batch.py` -> `pipelines/engine.py`) on an NVIDIA H100.
The three Pallas kernels of that path are hand-written CUDA C++ kernels
(`csrc/*.cu`, built at first use by `ops/cuda_build.py`); every kernel has a
plain PyTorch version beside it, which is what runs for CPU tensors. It
also reproduces the trainers (`cli/train_dc_focal.py`, `cli/train.py` ->
`train/trainer.py`), whose checkpoints are the JAX package's msgpack files
(`checkpoint/native.py`, the port's own codec).

This package imports torch, numpy, scipy, pandas, cv2 and PIL — never jax,
flax, optax, sklearn or `unetdc_tpu`.
"""

__version__ = "0.1.0"
