"""Command-line entry points (counterpart of azoom.cli):

  python -m azoom_torch.cli.batch --n 50   (the vectorized batch sweep)
  python -m azoom_torch.cli.train --model fpu --steps 2000   (training)

The other entry points of the reference (run, analyze, debug_srp,
dereverb, diagnose, plot_eval, zoom_study) are not ported (ROADMAP.md Queue
A item 10), nor is batch's ``--ckpt`` checkpoint directory (item 9d).
"""
