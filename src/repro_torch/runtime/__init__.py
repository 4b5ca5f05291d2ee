"""Training runtime (PyTorch): train steps and the fault-tolerant trainer."""
