"""Graph ops: segment reductions, sparse connectivity, kernels."""
