"""Evaluation helpers of the port: the classical interpolation baselines
(``baselines.py``) that quality reports put beside the model."""
