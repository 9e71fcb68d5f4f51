"""The benchmark of spumoni_tpu_torch: whole `spumoni run` calls, timed,
traced and checked against a plain NumPy and PyTorch reference (see run.py)."""
