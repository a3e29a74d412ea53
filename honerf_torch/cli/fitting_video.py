"""The video pose-fitting command line, the same arguments as
honerf_tpu.cli.fitting_video:

    python -m honerf_torch.cli.fitting_video --conf ./fit_confs/fit_123_8views_0.conf --case 123_8view_id0
    python -m honerf_torch.cli.fitting_video --conf ./fit_confs/fit_1234_8views_0.conf --case 1234_8view_id0

It starts from the pose pickles '12' wrote.  It runs on the CUDA device
--gpu (default 0); the CPU is reachable only through the Python API
(VideoFitRunner(..., device="cpu")).  --mode is accepted and ignored, as
in the reference.
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
    parser.add_argument("--mode", type=str, default="fitting")
    parser.add_argument("--gpu", type=int, default=0)
    parser.add_argument("--case", type=str, default="")
    args = parser.parse_args(argv)
    if not os.path.exists(args.conf):
        raise SystemExit(f"config file not found: {args.conf}")

    import torch

    from honerf_torch.fit.runner import VideoFitRunner

    device = torch.device("cuda", args.gpu)
    if torch.cuda.is_available():
        torch.cuda.set_device(device)  # the kernels launch on the current device
    VideoFitRunner(args.conf, args.case, device=device).fitting()


if __name__ == "__main__":
    main()
