"""Math helpers, the input normalizer and the ensemble-MLP kernels."""
