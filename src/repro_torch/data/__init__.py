"""Seeded synthetic data for the port's tests and runs."""
