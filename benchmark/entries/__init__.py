"""The entries: one module per unit of the program that a window drives."""
