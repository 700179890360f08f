"""azoom_torch.masks: see the package docstring."""
