"""The plain reference that decides ``correct``: plain PyTorch, importing
nothing of the program and taking nothing that the program made."""
