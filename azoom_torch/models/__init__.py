"""azoom_torch.models: see the package docstring."""
