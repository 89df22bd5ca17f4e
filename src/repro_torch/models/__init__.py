"""Decoder model: layers, attention, blocks and the language model."""
