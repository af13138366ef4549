"""tpu_llm_torch — the PyTorch/CUDA port of ``tpu_llm`` for NVIDIA Hopper.

A second package beside the JAX one, with the same module paths so each
counterpart is found under the same name. It imports ``torch`` and numpy,
never ``jax`` and nothing of ``tpu_llm``: the host-side helpers it needs
(GGUF reader/writer, block codecs, BPE tokenizer, config) are its own
copies.

Where the JAX package runs a Pallas kernel on the TPU, the port runs a
CUDA C++ kernel written for ``sm_90a`` (sources in ``csrc/``, built at
first use by ``kernels/build.py``). Each kernel has a plain PyTorch twin
in the same module: the wrapper takes the twin for CPU tensors (the
tests) and launches the kernel, or raises, for CUDA tensors.

Importing the package builds nothing and touches no device.
"""

__version__ = "0.1.0"
