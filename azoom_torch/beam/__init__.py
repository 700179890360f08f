"""azoom_torch.beam: see the package docstring."""
