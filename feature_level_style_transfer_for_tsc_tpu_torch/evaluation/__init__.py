"""Accuracy, precision weights and the ensemble vote rules."""
