"""Models (the GMM-prior structured VAE)."""
