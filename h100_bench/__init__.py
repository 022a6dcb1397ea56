"""The benchmark of fourier_feature_nets_torch on NVIDIA H100 cards (see
README.md): one command runs one cell once."""
