"""Host-side oracle implementations of the CT container formats.

These are slow, scalar, obviously-correct Python/NumPy implementations used
as the ground truth for the JAX and CUDA kernels: every device codec must
produce byte-identical containers (tests/test_*_jax.py). They implement the
same format specs (FORMATS.md) — they are not translations of the reference
C++ (which uses different formats; see SURVEY.md §7).
"""
