"""Training from the command line (counterpart of azoom.cli.train):

    python -m azoom_torch.cli.train --model deepfpu --features physics --steps 5000

On-the-fly synthesized (or corpus) batches, Adam and BCE, checkpoints with
automatic resume (``train.loop``), data parallel over every card with
``--dp``. Runs on the card unless ``--device cpu``. The trained net's
variables are flax-shaped: ``models.quantize.calibrate_act_scales`` and
``save_quantized`` export it as an int8 artifact that ``convert.from_flax``
serves.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="azoom_torch.train")
    p.add_argument("--model", default="fpu",
                   choices=["fpu", "deepfpu", "tpufpu", "blstm", "crn", "qcnn"])
    p.add_argument("--fold", type=int, default=4,
                   help="tpufpu only: frequency space-to-depth factor")
    p.add_argument("--bneck", type=int, default=8,
                   help="tpufpu only: bottleneck width multiplier "
                        "(channels = base * bneck; 4 = the slim variant)")
    p.add_argument("--init-from", default=None,
                   help="bundled artifact name to warm-start from (e.g. 'tpufpu'); "
                        "model/base/fold must match the artifact")
    p.add_argument("--features", default="logmag_ipd", choices=["logmag_ipd", "physics"])
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--base", type=int, default=32, help="base channel width")
    p.add_argument("--seconds", type=float, default=2.0, help="crop length")
    p.add_argument("--reverb", action="store_true",
                   help="train on room-acoustics (image-source RIR) scenes")
    p.add_argument("--angle-jitter", type=float, default=0.0,
                   help="randomize source angles by +/- this many degrees")
    p.add_argument("--corpus", default=None,
                   help="directory of real WAVs to train on (default: env AZOOM_DATA_DIR "
                        "if set, else synthesized speech)")
    p.add_argument("--native-loader", action="store_true",
                   help="prefetch corpus batches through the C++ corpus engine")
    p.add_argument("--causal", action="store_true",
                   help="blstm and crn: unidirectional (streaming frame-latency)")
    p.add_argument("--pinn-weight", type=float, default=0.0,
                   help="weight of the physics-informed IPD-consistency residual "
                        "(0 = plain BCE)")
    p.add_argument("--ckpt", default="checkpoints/mask_estimator")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dp", action="store_true", help="data-parallel over every CUDA device")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA; 'cpu' for the plain path)")
    return p


def build_model(args):
    """The trainable twin the reference's CLI builds for these arguments."""
    from azoom_torch.models import trainable

    if args.model == "blstm":
        from azoom_torch.models.blstm import BLSTMMaskNet

        return BLSTMMaskNet(hidden=8 * args.base, unidirectional=args.causal)
    if args.model == "crn":
        return trainable.CRNMaskNet(base=args.base // 2, hidden=4 * args.base,
                                    unidirectional=args.causal)
    if args.model == "tpufpu":
        return trainable.TPUFPU(base=args.base, fold=args.fold, bneck=args.bneck)
    if args.model == "qcnn":
        from azoom_torch.models.qcnn import QCNNMaskNet

        if args.features != "physics":
            raise SystemExit("qcnn reads quaternion (physics) features; pass --features physics")
        return QCNNMaskNet(base=max(args.base // 4, 1))
    cls = trainable.FreqPreservingUNet if args.model == "fpu" else trainable.DeepFPU
    return cls(base=args.base)


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from azoom_torch.config import DEFAULT, resolve_device
    from azoom_torch.train.loop import fit

    device = resolve_device(args.device)
    cfg = DEFAULT.replace(mic_dist=0.04)
    model = build_model(args)
    init_variables = None
    if args.init_from is not None:
        from azoom_torch.models.trainable import from_bundled

        net, bundled_feats = from_bundled(args.init_from, cfg.n_freqs, device)
        if bundled_feats != args.features:
            raise SystemExit(f"--init-from {args.init_from} was trained on '{bundled_feats}' "
                             f"features; pass --features {bundled_feats}")
        init_variables = net.variables()
        print(f"[TRAIN] warm-starting from bundled '{args.init_from}'")
    mesh = None
    if args.dp and device.type == "cuda" and torch.cuda.device_count() > 1:
        from azoom_torch.parallel.mesh import make_mesh

        mesh = make_mesh()
        print(f"[TRAIN] data-parallel over {mesh.size} devices")

    result = fit(
        model, cfg, n_steps=args.steps, batch_size=args.batch, learning_rate=args.lr,
        feature_kind=args.features, n_samples=int(args.seconds * cfg.fs), reverb=args.reverb,
        angle_jitter_deg=args.angle_jitter, pinn_weight=args.pinn_weight,
        native_loader=args.native_loader,
        corpus_root=args.corpus or os.environ.get("AZOOM_DATA_DIR"),
        init_variables=init_variables, seed=args.seed, checkpoint_dir=args.ckpt,
        resume=not args.no_resume, mesh=mesh, device=device,
    )
    print(f"[TRAIN] finished at step {int(result.state.step)}; ckpt in {args.ckpt}")
    return result


if __name__ == "__main__":
    main()
