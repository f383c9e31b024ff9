"""protein_transformer_tpu_torch: the PyTorch/CUDA port of protein_transformer_tpu.

It mirrors the JAX package's layout and names (ops/, protein/, models/,
data/, training/, losses.py, config.py) and runs on an NVIDIA Hopper GPU,
with the JAX package's Pallas kernels rewritten as hand-written CUDA
kernels (csrc/). It imports torch and never jax, flax or any module of the
JAX package: it keeps its own copies of that package's numpy-only modules
(protein constants, vocabulary, force-field tables and training metrics),
which tests/test_torch_imports.py holds equal to the originals.
"""
__version__ = "0.1.0"
