"""protein_transformer_tpu_torch: the PyTorch/CUDA port of protein_transformer_tpu.

It mirrors the JAX package's layout and names (ops/, protein/, models/,
data/, training/, losses.py, config.py) and runs on an NVIDIA Hopper GPU,
with the JAX package's Pallas kernels rewritten as hand-written CUDA
kernels (csrc/). It imports torch and never jax or flax; the JAX package's
numpy-only modules (protein constants, vocabulary, force-field tables and
training metrics) are shared rather than copied.
"""
__version__ = "0.1.0"
