"""Seeded synthetic data for the port."""
