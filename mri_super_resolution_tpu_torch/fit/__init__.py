"""Fit engine: losses, Adam, fit loops and chunked dense-grid inference."""
