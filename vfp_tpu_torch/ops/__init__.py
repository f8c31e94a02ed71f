"""Tensor ops of the ported codecs: colour, Haar DWT, 8x8 DCT, SoA block layout."""
