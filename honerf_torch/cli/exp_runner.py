"""The offline stage's command line: train / test / mesh modes, the same
arguments as honerf_tpu.cli.exp_runner:

    python -m honerf_torch.cli.exp_runner --mode train \
        --conf ./confs/wmask_realobj_bean.conf --case bean
    python -m honerf_torch.cli.exp_runner --mode test --conf ... --is_continue
    python -m honerf_torch.cli.exp_runner --mode mesh --conf ... --is_continue

It runs on the CUDA device --gpu (default 0); the CPU is reachable only
through the Python API (OfflineRunner(..., device="cpu")).
"""

import argparse
import logging
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="[%(filename)s:%(lineno)s - %(funcName)s() ] %(message)s")
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf", type=str, default="./confs/base.conf")
    parser.add_argument("--mode", type=str, default="train")
    parser.add_argument("--mcube_threshold", type=float, default=0.0)
    parser.add_argument("--is_continue", default=False, action="store_true")
    parser.add_argument("--gpu", type=int, default=0)
    parser.add_argument("--case", type=str, default="")
    args = parser.parse_args(argv)

    if args.mode not in ("train", "test", "mesh"):
        raise SystemExit(f"unknown mode {args.mode!r} (train|test|mesh)")
    if not os.path.exists(args.conf):
        raise SystemExit(f"config file not found: {args.conf}")

    import torch

    from honerf_torch.train.runner import OfflineRunner

    device = torch.device("cuda", args.gpu)
    if torch.cuda.is_available():
        torch.cuda.set_device(device)  # the kernels launch on the current device
    runner = OfflineRunner(args.conf, args.mode, args.case, args.is_continue, device=device)
    if args.mode == "train":
        runner.train()
    elif args.mode == "mesh":
        runner.validate_mesh(resolution=256, threshold=args.mcube_threshold)
    else:
        runner.test()


if __name__ == "__main__":
    main()
