"""Multi-source ensemble on one card."""
