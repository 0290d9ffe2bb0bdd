"""The plain reference of the benchmark: plain PyTorch and numpy, which
imports nothing of the program under test."""
