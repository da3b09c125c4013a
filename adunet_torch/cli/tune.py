"""Hyperparameter tuning CLI for both workloads.

Port of ``adunet/cli/tune.py`` with the same flags, search spaces, study,
results JSON and retrain artifacts, plus ``--device`` (``cuda`` by default,
which raises without a GPU; ``cpu`` runs the kernels' plain versions).

- **SR** (u_net_vanilla_optuna.py:160-250): TPE over lr, the combined loss's
  alpha / beta / gamma and the batch size on the vanilla U-Net (float32,
  base ``--sr-base-channels``), minimising the best validation loss. HR
  images come from ``--high-res-dir``; LR images from ``--low-res-dir``
  (paired by name) or ``degrade(hr, 0.5, image_size)`` on the device. The
  perceptual term runs over the seeded VGG19 tower (no ImageNet weights are
  in the repository; the reference draws its own seeded tower). Sequential
  trials run as one-lane groups of ``adunet_torch.tune.BatchedVanillaSRTuner``
  with live pruning through ``on_epoch``, as the reference's do, so
  sequential and laned studies share one training path.
- **seg**: TPE over lr, base channels (unless ``--base-channels`` pins
  them), depth, batch size and augmentation on the adaptive BatchNorm seg
  U-Net over ISIC pairs, maximising the best validation Dice. Augmentation
  draws from a ``torch.Generator`` on the device seeded with ``--seed``
  (``jax.random``'s stream cannot be reproduced).
- ``--parallel-trials K`` > 1 (SR only; seg raises the reference's
  ``ValueError``): constant-liar batched asks, each round's trials grouped by
  batch size and trained as lanes. ``--retrain`` trains the best config for
  ``--final-epochs`` (default twice ``--epochs``) into
  ``<model-dir>/unet_vanilla_tuned_best`` or ``unet_seg_tuned_best`` with a
  ``config.json`` of the reference's keys. The study's JSON is written before
  the retrain.
- cuDNN runs its deterministic algorithms for the whole study
  (``adunet_torch.utils.deterministic_cudnn``), so a seed repeats a study
  bit for bit, values and pruning included, as the reference's XLA
  programs do, and a laned trial equals its sequential run exactly.

    python -m adunet_torch.cli.tune --workload sr --high-res-dir HR --n-trials 20 \\
        [--parallel-trials 3] [--retrain] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Tune U-Net hyperparameters (PyTorch).")
    parser.add_argument("--workload", choices=["sr", "seg"], required=True)
    parser.add_argument("--n-trials", type=int, default=20)
    parser.add_argument("--epochs", type=int, default=10, help="Epochs per trial.")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--results", type=Path, default=Path("runs/tune_results.json"))
    parser.add_argument("--pruner", choices=["median", "hyperband", "none"], default="median")
    parser.add_argument("--pruner-warmup-steps", type=int, default=1,
                        help="No pruning before this many reported epochs per trial. "
                             "Raise for identity-start SR studies: the fidelity study "
                             "(experiments/round4_sweep/tune_fidelity) measured the default "
                             "median rule discarding the true top-2 slow-starting configs.")
    parser.add_argument("--pruner-warmup-trials", type=int, default=2,
                        help="No pruning before this many completed reference trials.")
    parser.add_argument("--sampler", choices=["tpe", "random"], default="tpe")
    parser.add_argument("--parallel-trials", type=int, default=1,
                        help="Evaluate this many trials together as lanes on the card (SR "
                             "workload; built-in engine with constant-liar batched TPE "
                             "asks). 1 = sequential.")
    parser.add_argument("--retrain", action="store_true",
                        help="Retrain the best config after the study and save the model "
                             "(reference train_final_model, u_net_vanilla_optuna.py:209-250).")
    parser.add_argument("--final-epochs", type=int, default=None,
                        help="Epochs for the best-config retrain (default: 2x trial epochs).")
    parser.add_argument("--model-dir", type=Path, default=Path("runs/models"))
    # SR data
    parser.add_argument("--high-res-dir", type=str, default=None)
    parser.add_argument("--low-res-dir", type=str, default=None,
                        help="Paired LR directory; when absent LR is synthesised at 0.5.")
    parser.add_argument("--image-suffix", type=str, default=".png")
    parser.add_argument("--sr-base-channels", type=int, default=64,
                        help="Vanilla SR U-Net width (reference fixes 64).")
    # seg data
    parser.add_argument("--train-images", type=str, default=None)
    parser.add_argument("--train-masks", type=str, default=None)
    parser.add_argument("--val-images", type=str, default=None)
    parser.add_argument("--val-masks", type=str, default=None)
    parser.add_argument("--base-channels", type=int, default=None,
                        help="Pin base channels instead of searching (seg).")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; raises without a GPU) or cpu.")
    return parser.parse_args(argv)


@dataclass
class Workload:
    """What ``main`` needs of a workload: the objective and its direction,
    the best-config retrain, the sequential trainer ``run_config`` (the
    retrain's, and a test's oracle) and, for SR, ``parallel`` =
    ``(suggest_params, make_runner)`` for laned studies."""

    objective: Callable
    direction: str
    retrain: Callable
    run_config: Callable
    parallel: Optional[Tuple[Callable, Callable]] = None


def _weighted_mean(vals: List[torch.Tensor], weights: List[int]) -> float:
    """The mean of per-batch values weighted by batch size (one device read)."""
    return float(np.average(torch.stack(vals).cpu().numpy(), weights=weights))


def _sr_workload(args, dev: torch.device) -> Workload:
    """Reference search space (u_net_vanilla_optuna.py:160-170): TPE over
    lr/alpha/beta/gamma/batch on the vanilla U-Net with the combined
    MSE+SSIM+VGG loss, minimising best val_loss."""
    from adunet_torch.data import ArrayDataset, find_images, load_rgb_image, pair_lr_files
    from adunet_torch.losses import build_losses_and_metrics, make_perceptual_fn
    from adunet_torch.models import build_vanilla_sr_unet
    from adunet_torch.ops import degrade
    from adunet_torch.train import (
        CheckpointManager,
        create_train_state,
        make_optimizer,
        make_vanilla_sr_train_step,
        make_vanilla_sr_val_step,
        repeat,
    )
    from adunet_torch.tune import BatchedVanillaSRTuner, TrialPruned
    from adunet_torch.utils.misc import split_indices

    hr_paths = find_images(args.high_res_dir, args.image_suffix, args.limit)
    hr_images = np.stack([load_rgb_image(p, args.image_size) for p in hr_paths])
    if args.low_res_dir:
        # pair by filename — a same-count directory listing is not evidence
        # of alignment (hard-errors on missing counterparts)
        lr_paths = pair_lr_files(hr_paths, args.low_res_dir)
        lr_images = np.stack([load_rgb_image(p, args.image_size) for p in lr_paths])
    else:
        with torch.no_grad():
            lr_images = degrade(torch.from_numpy(hr_images).to(dev), 0.5,
                                args.image_size).cpu().numpy()
    tr_idx, va_idx, _ = split_indices(len(hr_paths), 0.8, 0.2, 0.0, args.seed)

    # one perceptual tower shared across trials (the weights never change)
    perceptual_fn = make_perceptual_fn(input_size=args.image_size, device=dev)

    def run_config(lr_rate, alpha, beta, gamma, batch_size, epochs, trial=None, ckpt=None):
        train_ds = ArrayDataset(
            lr_images[np.asarray(tr_idx)], hr_images[np.asarray(tr_idx)],
            batch_size=batch_size, shuffle=True, seed=args.seed,
        )
        val_ds = ArrayDataset(
            lr_images[np.asarray(va_idx)], hr_images[np.asarray(va_idx)],
            batch_size=batch_size, shuffle=False, seed=args.seed,
        )
        model = build_vanilla_sr_unet(base_channels=args.sr_base_channels, device=dev,
                                      seed=args.seed)
        loss_fn, _m = build_losses_and_metrics(
            "combined", perceptual_fn=perceptual_fn, alpha=alpha, beta=beta, gamma=gamma
        )
        state = create_train_state(model, make_optimizer(model.parameters(), lr_rate))
        step = make_vanilla_sr_train_step(model, loss_fn)
        val_step = make_vanilla_sr_val_step(model, loss_fn)

        it = repeat(train_ds)
        best = np.inf
        for epoch in range(epochs):
            for _ in range(train_ds.steps_per_epoch):
                state, _metrics = step(state, next(it))
            vals, weights = [], []
            for lr_b, hr_b in val_ds:
                vals.append(val_step(state, (lr_b, hr_b))["loss"])
                weights.append(lr_b.shape[0])
            val_loss = _weighted_mean(vals, weights)
            best = min(best, val_loss)
            if ckpt is not None:
                ckpt.save(epoch + 1, state, metrics={"val_loss": val_loss})
            if trial is not None:
                trial.report(val_loss, epoch)
                if trial.should_prune():
                    raise TrialPruned()
        return best

    def suggest_params(trial) -> dict:
        """Reference search space; shared by the sequential objective and the
        laned ask_batch path (identical suggest order matters: the sampler's
        per-trial RNG stream is positional)."""
        return {
            "lr": trial.suggest_float("lr", 1e-5, 5e-3, log=True),
            "alpha": trial.suggest_float("alpha", 0.5, 2.0),
            "beta": trial.suggest_float("beta", 1e-3, 0.5, log=True),
            "gamma": trial.suggest_float("gamma", 1e-4, 0.1, log=True),
            "batch_size": trial.suggest_categorical("batch_size", [4, 8, 16]),
        }

    def make_runner(lane_width=None) -> BatchedVanillaSRTuner:
        return BatchedVanillaSRTuner(
            lr_images, hr_images, tr_idx, va_idx,
            base_channels=args.sr_base_channels, seed=args.seed,
            perceptual_fn=perceptual_fn, lane_width=lane_width, device=dev,
        )

    # Sequential trials are one-lane groups of the laned runner, as in the
    # reference: lane 0 reproduces run_config's trial (same init, shuffle
    # stream and loss; tests/test_torch_tune_parallel.py holds them to rtol
    # 2e-4), so values and pruning decisions are unchanged.
    seq_runner_box: list = []

    def objective(trial) -> float:
        p = suggest_params(trial)
        if not seq_runner_box:
            seq_runner_box.append(make_runner())
        pruned = False

        def on_epoch(epoch: int, last_vals) -> bool:
            nonlocal pruned
            trial.report(last_vals[0], epoch)
            pruned = trial.should_prune()
            return pruned

        curve = seq_runner_box[0].run_group(
            [p], int(p["batch_size"]), args.epochs, on_epoch=on_epoch
        )[0]
        if pruned:
            raise TrialPruned()
        return min(curve)

    def retrain(best_params) -> dict:
        final_epochs = args.final_epochs or 2 * args.epochs
        ckpt_dir = Path(args.model_dir).expanduser() / "unet_vanilla_tuned_best"
        ckpt = CheckpointManager(ckpt_dir, monitor="val_loss", mode="min")
        best = run_config(
            float(best_params["lr"]), float(best_params["alpha"]),
            float(best_params["beta"]), float(best_params["gamma"]),
            int(best_params["batch_size"]), final_epochs, ckpt=ckpt,
        )
        ckpt.write_config({"workload": "sr", **best_params, "final_epochs": final_epochs})
        ckpt.close()
        return {"final_val_loss": best, "checkpoint": str(ckpt_dir)}

    return Workload(objective, "minimize", retrain, run_config,
                    parallel=(suggest_params, lambda: make_runner(args.parallel_trials)))


def _seg_workload(args, dev: torch.device) -> Workload:
    from adunet_torch.data import build_isic_dataset
    from adunet_torch.losses import make_bce_dice_loss
    from adunet_torch.models import build_adaptive_depth_unet
    from adunet_torch.train import (
        CheckpointManager,
        create_train_state,
        make_optimizer,
        make_seg_eval_step,
        make_seg_train_step,
        repeat,
    )
    from adunet_torch.tune import TrialPruned

    def run_config(lr, base_channels, depth, batch_size, augment, epochs,
                   trial=None, ckpt=None, init_state=None):
        """One seg trial; ``init_state`` (a state_dict) replaces the seeded
        init (a test's hook)."""
        train_ds, n_train = build_isic_dataset(
            args.train_images, args.train_masks, batch_size=batch_size,
            image_size=args.image_size, augment=augment, shuffle=True,
            seed=args.seed, limit=args.limit,
        )
        val_ds, _ = build_isic_dataset(
            args.val_images, args.val_masks, batch_size=batch_size,
            image_size=args.image_size, augment=False, shuffle=False,
            seed=args.seed, limit=args.limit,
        )
        steps_per_epoch = math.ceil(n_train / batch_size)

        model = build_adaptive_depth_unet(args.image_size, base_channels, depth, device=dev,
                                          seed=args.seed)
        if init_state is not None:
            model.load_state_dict(init_state)
        loss_fn = make_bce_dice_loss(0.5, 1.0)
        state = create_train_state(model, make_optimizer(model.parameters(), lr))
        step = make_seg_train_step(model, loss_fn, augment=augment)
        eval_step = make_seg_eval_step(model, loss_fn)

        rng = torch.Generator(device=dev).manual_seed(args.seed)
        best = -np.inf

        it = repeat(train_ds)
        for epoch in range(epochs):
            for _ in range(steps_per_epoch):
                state, _metrics = step(state, next(it), rng)
            vals, weights = [], []
            for images, masks in val_ds:
                vals.append(eval_step(state, (images, masks))["dice"])
                weights.append(images.shape[0])
            val_dice = _weighted_mean(vals, weights)
            best = max(best, val_dice)
            if ckpt is not None:
                ckpt.save(epoch + 1, state, metrics={"val_dice": val_dice})
            if trial is not None:
                trial.report(val_dice, epoch)
                if trial.should_prune():
                    raise TrialPruned()
        return best

    def objective(trial) -> float:
        lr = trial.suggest_float("learning_rate", 1e-5, 1e-2, log=True)
        base_channels = args.base_channels or trial.suggest_categorical("base_channels", [16, 32, 64])
        depth = trial.suggest_int("depth", 3, 5)
        batch_size = trial.suggest_categorical("batch_size", [8, 16])
        augment = trial.suggest_categorical("augment", [True, False])
        return run_config(lr, base_channels, depth, batch_size, augment, args.epochs, trial=trial)

    def retrain(best_params) -> dict:
        final_epochs = args.final_epochs or 2 * args.epochs
        ckpt_dir = Path(args.model_dir).expanduser() / "unet_seg_tuned_best"
        ckpt = CheckpointManager(ckpt_dir, monitor="val_dice", mode="max")
        best = run_config(
            float(best_params["learning_rate"]),
            int(best_params.get("base_channels", args.base_channels or 32)),
            int(best_params["depth"]),
            int(best_params["batch_size"]),
            bool(best_params["augment"]),
            final_epochs,
            ckpt=ckpt,
        )
        ckpt.write_config({"workload": "seg", **best_params, "final_epochs": final_epochs})
        ckpt.close()
        return {"final_val_dice": best, "checkpoint": str(ckpt_dir)}

    return Workload(objective, "maximize", retrain, run_config)


def run_parallel_study(study, args, suggest_params, make_runner) -> None:
    """Drive the study in batches of trials trained as lanes.

    Each round asks ``--parallel-trials`` configs at once (constant-liar
    batched TPE, ``Study.ask_batch``), groups them by the one shape-affecting
    parameter (batch size), and trains each group as lanes on the card
    (``adunet_torch.tune.parallel``). The sequential objective's value is the
    val-loss curve minimum; the per-epoch curve is recorded as the trial's
    intermediate values so the results payload is shape-compatible with
    sequential studies.
    """
    from adunet_torch.tune import group_trials_by

    runner = make_runner()
    remaining = args.n_trials
    while remaining > 0:
        k = min(args.parallel_trials, remaining)
        asked = study.ask_batch(suggest_params, k)
        for batch_size, group in group_trials_by(asked, "batch_size").items():
            curves = runner.run_group(
                [t.params for t in group], int(batch_size), args.epochs
            )
            for trial, curve in zip(group, curves):
                for epoch, value in enumerate(curve):
                    trial.report(value, epoch)
                study.tell(trial, min(curve))
        remaining -= k


def main(argv: Optional[List[str]] = None) -> dict:
    from adunet_torch.utils.runtime import deterministic_cudnn, resolve_device

    args = parse_args(argv)
    if args.parallel_trials < 1:
        raise ValueError("--parallel-trials must be >= 1")
    if args.workload == "sr":
        if not args.high_res_dir:
            raise ValueError("--high-res-dir is required for --workload sr")
    else:
        for flag in ("train_images", "train_masks", "val_images", "val_masks"):
            if not getattr(args, flag):
                raise ValueError(f"--{flag.replace('_', '-')} is required for --workload seg")
        if args.parallel_trials > 1:
            raise ValueError(
                "--parallel-trials > 1 is only supported for --workload sr "
                "(the seg search space varies model shape per trial, which "
                "cannot be stacked into lanes of one model)."
            )
    dev = resolve_device(args.device)
    with deterministic_cudnn():  # a seeded study repeats bit for bit
        return _run_study(args, dev)


def _run_study(args, dev: torch.device) -> dict:
    from adunet_torch.tune import create_study

    workload = (_sr_workload if args.workload == "sr" else _seg_workload)(args, dev)
    if args.parallel_trials > 1:
        # a laned study needs ask_batch/tell — built-in engine only
        study = create_study(
            direction=workload.direction, seed=args.seed, pruner=args.pruner,
            sampler=args.sampler, prefer_optuna=False,
            pruner_warmup_trials=args.pruner_warmup_trials,
            pruner_warmup_steps=args.pruner_warmup_steps,
        )
        suggest_params, make_runner = workload.parallel
        run_parallel_study(study, args, suggest_params, make_runner)
    else:
        study = create_study(
            direction=workload.direction, seed=args.seed, pruner=args.pruner,
            sampler=args.sampler,
            pruner_warmup_trials=args.pruner_warmup_trials,
            pruner_warmup_steps=args.pruner_warmup_steps,
        )
        study.optimize(workload.objective, n_trials=args.n_trials)

    args.results.parent.mkdir(parents=True, exist_ok=True)
    if hasattr(study, "results_payload"):
        payload = study.results_payload()
    else:  # optuna study
        payload = {
            "best_value": study.best_value,
            "best_params": study.best_params,
            "n_trials": len(study.trials),
        }
    # persist the study BEFORE the optional retrain: a crash during the
    # retrain must not discard hours of completed trials
    args.results.write_text(json.dumps(payload, indent=2, default=str))

    if args.retrain:
        print(f"Retraining best config: {study.best_params}")
        retrain_result = workload.retrain(study.best_params)
        print(f"Retrain result: {retrain_result}")
        payload["retrain"] = retrain_result
        args.results.write_text(json.dumps(payload, indent=2, default=str))
    print(f"Best value: {study.best_value}")
    print(f"Best params: {study.best_params}")
    print(f"Results written to {args.results}")
    return payload


if __name__ == "__main__":
    main()
