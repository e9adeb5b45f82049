"""Models: the GMM-prior structured VAE and the pure-mixture baselines."""
