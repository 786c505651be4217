"""Losses and metrics of the training path."""
