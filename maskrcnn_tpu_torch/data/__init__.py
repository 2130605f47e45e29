"""Synthetic request data."""
