"""The plain reference: PyTorch written from the published algorithms, importing nothing of the program."""
