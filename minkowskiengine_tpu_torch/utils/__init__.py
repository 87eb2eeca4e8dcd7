"""Weight import and synthetic data."""
