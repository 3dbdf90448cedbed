"""Experiments of the JAX package that a model option reaches: the
phase-space algebra of ``UNetSuperRes(phase_final=True)`` (``phase.py``)."""
