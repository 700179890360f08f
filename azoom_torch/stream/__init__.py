"""azoom_torch.stream: see the package docstring."""
