"""azoom_torch.pipelines: see the package docstring."""
