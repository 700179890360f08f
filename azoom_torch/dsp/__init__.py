"""azoom_torch.dsp: see the package docstring."""
