"""Serving parts of the classifier and of the style-transfer pipeline."""
