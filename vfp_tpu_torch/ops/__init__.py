"""Tensor ops of the flagship codec: colour, Haar DWT, SoA block layout."""
