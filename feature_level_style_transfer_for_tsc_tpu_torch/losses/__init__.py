"""Training losses: classification, CDAN, WGAN critic, GradNorm balancing."""
