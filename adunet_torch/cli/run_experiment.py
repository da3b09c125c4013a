"""Experiment sweep launcher.

Port of ``adunet/cli/run_experiment.py``: a rebuild of the reference sweep
drivers (run_experiment_fixed_depth.sh / run_experiment_adaptive_depth.sh)
plus real segmentation sweep support.
Modes:
- ``--mode print``  : show the planned runs (dry run)
- ``--mode run``    : execute runs sequentially in-process
- ``--mode sbatch`` : emit one SLURM sbatch script per run (cluster parity)

Each run writes a metadata txt before launch, matching the reference's
metadata emission (run_experiment_fixed_depth.sh:87-95). After an SR run
completes in ``run`` mode, the offline evaluator is invoked on its checkpoint
— the auto-eval step of train_adaptive_simple.sbatch:202-224.

The SR plans' batches come from the H100 table (``adunet_torch.experiments.
H100_BATCH_SIZES``) unless ``--reference_batches``; under it every plan equals
the JAX package's argument for argument. ``--device`` (``cuda`` by default,
raising without a GPU, or ``cpu``) goes to the trainer or the tuner and to
the auto-eval ``evaluate``; in print and sbatch modes the command lines name
it only when it is not the default, as the port's CLIs default to ``cuda``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Launch an experiment sweep.")
    parser.add_argument("--experiment", required=True,
                        choices=["fixed_depth", "adaptive_depth", "seg_protocols",
                                 "tune_sr", "tune_seg"])
    parser.add_argument("--n_trials", type=int, default=20,
                        help="Trial budget for tune_sr/tune_seg experiments.")
    parser.add_argument("--trial_epochs", type=int, default=10,
                        help="Epochs per tuning trial (tune_sr/tune_seg); the sweep-level "
                             "--epochs flag applies to training experiments only.")
    parser.add_argument("--mode", choices=["print", "run", "sbatch"], default="print")
    parser.add_argument("--high_res_dir", type=str, default=None)
    parser.add_argument("--train_images", type=str, default=None)
    parser.add_argument("--train_masks", type=str, default=None)
    parser.add_argument("--val_images", type=str, default=None)
    parser.add_argument("--val_masks", type=str, default=None)
    parser.add_argument("--model_dir", type=str, default="runs/models")
    parser.add_argument("--log_dir", type=str, default="runs/logs")
    parser.add_argument("--metadata_dir", type=str, default="runs/metadata")
    parser.add_argument("--epochs", type=int, default=None,
                        help="Epochs per run. Default: 100 for SR sweeps; the protocol's own "
                             "budget (A:100, B:200) for seg sweeps.")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--scales", type=float, nargs="*", default=None)
    parser.add_argument("--protocols", type=str, nargs="*", default=["A", "B"])
    parser.add_argument("--seeds", type=int, nargs="*", default=[42])
    parser.add_argument("--reference_batches", action="store_true",
                        help="Use the reference's 2080Ti batch tables instead of H100 sizing.")
    parser.add_argument("--no_mixed_precision", action="store_true")
    parser.add_argument("--auto_eval", action="store_true",
                        help="Run the offline evaluator after each SR training run.")
    parser.add_argument("--eval_hr_dir", type=str, default=None)
    parser.add_argument("--eval_patch_size", type=int, default=256)
    parser.add_argument("--image_suffix", type=str, default=".png")
    parser.add_argument("--sbatch_dir", type=str, default="runs/sbatch")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; raises without a GPU) or cpu, for every run.")
    parser.add_argument("--extra_args", type=str, nargs=argparse.REMAINDER, default=[])
    return parser.parse_args(argv)


# the repo root is embedded at emission time: SLURM copies batch scripts to
# the slurmd spool directory, so a runtime `dirname $0` would not point back
# at the emit location
_SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --output={log_dir}/{name}-%j.log
#SBATCH --time=12:00:00
set -euo pipefail
cd {repo_root}
python -m adunet_torch.cli.{module} {args}
"""


def _device_args(args: argparse.Namespace) -> List[str]:
    """``--device`` for a printed or emitted command line: only off the default."""
    return [] if args.device == "cuda" else ["--device", args.device]


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)

    from adunet_torch.experiments import RunPlan, sweep_runs, write_metadata

    # Tuning jobs: single-plan experiments over the tune CLI — gives the
    # reference's tune_unet_optuna.sbatch an emission path (SURVEY §2.4).
    if args.experiment in ("tune_sr", "tune_seg"):
        if args.experiment == "tune_sr":
            if not args.high_res_dir:
                raise ValueError("tune_sr requires --high_res_dir")
            argv_tune = [
                "--workload", "sr",
                "--n-trials", str(args.n_trials),
                "--epochs", str(args.trial_epochs),
                "--high-res-dir", args.high_res_dir,
                "--image-suffix", args.image_suffix,
                "--results", str(Path(args.log_dir) / "tune_sr_results.json"),
                "--model-dir", args.model_dir,
                "--seed", str(args.seed),
                "--retrain",
            ]
        else:
            required = (args.train_images, args.train_masks, args.val_images, args.val_masks)
            if any(v is None for v in required):
                raise ValueError("tune_seg requires --train_images/--train_masks/--val_images/--val_masks")
            argv_tune = [
                "--workload", "seg",
                "--n-trials", str(args.n_trials),
                "--epochs", str(args.trial_epochs),
                "--train-images", args.train_images,
                "--train-masks", args.train_masks,
                "--val-images", args.val_images,
                "--val-masks", args.val_masks,
                "--results", str(Path(args.log_dir) / "tune_seg_results.json"),
                "--model-dir", args.model_dir,
                "--seed", str(args.seed),
                "--retrain",
            ]
        argv_tune += list(args.extra_args)
        plan = RunPlan(name=args.experiment, argv=argv_tune,
                       metadata={"experiment": args.experiment, "n_trials": args.n_trials})
        write_metadata(plan, Path(args.metadata_dir))
        if args.mode == "print":
            print(f"{plan.name}: python -m adunet_torch.cli.tune "
                  + " ".join(plan.argv + _device_args(args)))
        elif args.mode == "sbatch":
            sbatch_dir = Path(args.sbatch_dir)
            sbatch_dir.mkdir(parents=True, exist_ok=True)
            script = _SBATCH_TEMPLATE.format(
                name=plan.name, log_dir=args.log_dir, module="tune",
                args=" ".join(plan.argv + _device_args(args)),
                repo_root=Path(__file__).resolve().parents[2],
            )
            path = sbatch_dir / f"{plan.name}.sbatch"
            path.write_text(script)
            path.chmod(0o755)
            print(f"wrote {path}")
        else:
            from adunet_torch.cli.tune import main as tune_main

            tune_main(plan.argv + ["--device", args.device])
        return

    seg_dirs = None
    if args.experiment == "seg_protocols":
        seg_dirs = {
            "train_images": args.train_images,
            "train_masks": args.train_masks,
            "val_images": args.val_images,
            "val_masks": args.val_masks,
        }
        if any(v is None for v in seg_dirs.values()):
            raise ValueError("seg_protocols requires --train_images/--train_masks/--val_images/--val_masks")

    plans = sweep_runs(
        args.experiment,
        high_res_dir=args.high_res_dir,
        model_dir=args.model_dir,
        log_dir=args.log_dir,
        epochs=args.epochs,
        seed=args.seed,
        scales=args.scales,
        h100_batches=not args.reference_batches,
        mixed_precision=not args.no_mixed_precision,
        extra_args=args.extra_args,
        seg_dirs=seg_dirs,
        protocols=args.protocols,
        seeds=args.seeds,
    )

    module = "train_seg" if args.experiment == "seg_protocols" else "train_sr"
    metadata_dir = Path(args.metadata_dir)

    for plan in plans:
        write_metadata(plan, metadata_dir)

    if args.mode == "print":
        for plan in plans:
            print(f"{plan.name}: python -m adunet_torch.cli.{module} "
                  + " ".join(plan.argv + _device_args(args)))
        return

    if args.mode == "sbatch":
        sbatch_dir = Path(args.sbatch_dir)
        sbatch_dir.mkdir(parents=True, exist_ok=True)
        for plan in plans:
            script = _SBATCH_TEMPLATE.format(
                name=plan.name, log_dir=args.log_dir, module=module,
                args=" ".join(plan.argv + _device_args(args)),
                repo_root=Path(__file__).resolve().parents[2],
            )
            path = sbatch_dir / f"{plan.name}.sbatch"
            path.write_text(script)
            path.chmod(0o755)
            print(f"wrote {path}")
        return

    # mode == run: sequential in-process execution
    for plan in plans:
        print(f"=== {plan.name} ===", flush=True)
        if module == "train_sr":
            from adunet_torch.cli.train_sr import main as train_main

            train_main(plan.argv + ["--device", args.device])
            if args.auto_eval:
                from adunet_torch.cli.evaluate import main as eval_main

                scale = plan.metadata["scale"]
                depth = plan.metadata["depth"]
                ckpt = Path(args.model_dir) / f"unet_adaptive_scale{scale:.2f}_depth{depth}"
                eval_main([
                    "--model-path", str(ckpt),
                    "--scale", str(scale),
                    "--hr-dir", args.eval_hr_dir or args.high_res_dir,
                    "--image-suffix", args.image_suffix,
                    "--patch-size", str(args.eval_patch_size),
                    "--output-dir", str(Path(args.log_dir) / "evaluation"),
                    "--run-name", f"{plan.name}_eval",
                    "--device", args.device,
                ])
        else:
            from adunet_torch.cli.train_seg import main as seg_main

            seg_main(plan.argv + ["--device", args.device])


if __name__ == "__main__":
    main()
