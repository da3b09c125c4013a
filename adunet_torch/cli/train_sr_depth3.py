"""Train the SR U-Net at a fixed depth of 3 (Experiment 1).

Port of ``adunet/cli/train_sr_depth3.py``: ``train_sr`` with
``depth_override = max_depth = 3`` pinned, whatever the flags say.

    python -m adunet_torch.cli.train_sr_depth3 --scale 0.7 --high_res_dir DIR \\
        --image_suffix .npy [--device cpu]
"""

from __future__ import annotations

from typing import List, Optional

from adunet_torch.cli.train_sr import config_from_args, parse_args, train


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    args.depth_override = 3
    args.max_depth = 3
    return train(config_from_args(args))


if __name__ == "__main__":
    main()
