"""The benchmark of ``mri_superresolution_torch`` on NVIDIA H100s: one
cell a run (``run.py``), driven by ``BENCHMARK.json`` and the data files
beside this module. Nothing here imports JAX or the JAX package."""
