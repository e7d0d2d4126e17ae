"""Runnable end-to-end examples of the port on the synthetic dataset."""
