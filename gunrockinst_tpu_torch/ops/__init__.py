"""Kernel wrappers, their plain PyTorch versions and the word-map helpers."""
