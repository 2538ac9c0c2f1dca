"""Model code: the flagship transformer forward, decoding, int8 weights."""
