"""The plain reference of the paper's Algorithm 1 (PyTorch and numpy,
float32 with TF32 off), which imports nothing of the program."""
