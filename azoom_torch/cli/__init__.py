"""Command-line entry points (counterpart of azoom.cli), each run as
``python -m azoom_torch.cli.<name>``:

  run sim|inf|eval|full --name X   one run: simulate, enhance, score
  batch --n 50                     a campaign: vectorized sweeps, or --per-run
  train --model deepfpu            training, checkpoints with resume
  analyze                          describe() and plots of batch_metrics.csv
  debug_srp DIR                    the SRP scan of DIR/mixture.wav
  dereverb --outdir DIR            WPE of DIR/mixture.wav
  diagnose f.wav                   WAV sanity check (exit 1 on any issue)
  plot_eval REF.wav DEG.wav        STOI, PESQ and spectrograms
  zoom_study --out DIR             beam patterns and the sigma -> beamwidth curve

Every entry point that computes runs on the card unless ``--device cpu``;
diagnose and analyze stay on the host. analyze, debug_srp, plot_eval and
zoom_study plot with matplotlib and analyze reads with pandas, imported
only where they plot; reading a reference orbax checkpoint (``--ckpt``)
needs tensorstore.
"""
