"""PyTorch/CUDA port of the FedAdam-SSM system (see README, "PyTorch/CUDA port")."""
