"""repro_torch.launch — serve entry point."""
