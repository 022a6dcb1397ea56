"""The plain reference: float32 PyTorch with TF32 off, written from the
NeRF paper's equations and the documented behaviour of each cell's
entry point. It imports nothing of the program under test."""
