"""Synthetic problems the configurations name (benchmark/configs)."""
