"""The plain reference of the benchmark: the exact output distribution of a
noisy circuit, from its stim text, by a density-matrix simulation in plain
PyTorch. It imports nothing of the program under test and no JAX."""
