"""The plain float32 reference: plain PyTorch, no code of the program."""
