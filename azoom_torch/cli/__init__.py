"""Command-line entry points (counterpart of azoom.cli):

  python -m azoom_torch.cli.batch --n 50   (the vectorized batch sweep)

The other entry points of the reference (run, analyze, train, debug_srp,
dereverb, diagnose) are not ported (ROADMAP.md Queue A items 9 and 10).
"""
