"""azoom_torch.eval: see the package docstring."""
