"""Codecs of the quantized formats that need more than bit ops to decode."""
