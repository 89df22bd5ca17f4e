"""Entry points: greedy serving."""
