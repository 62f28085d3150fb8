"""The synthetic data stream of the port."""
