"""Coordinates, Fourier features, normalisation, interpolation, metrics, ADC."""
