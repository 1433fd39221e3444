"""The plain reference that decides ``correct``: plain PyTorch, imports
neither JAX nor anything of the program, and takes nothing the program made."""
