"""The benchmark's plain reference: SPUMONI's `build` and `run` worked out
again in NumPy from the strains alone (deployment.py; the suffix array is
sorted in plain PyTorch, suffix_array.py), to judge the port's output files. It imports neither JAX, the JAX package nor the port."""
