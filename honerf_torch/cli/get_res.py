"""The result-extraction command line, the same arguments as
honerf_tpu.cli.get_res:

    python -m honerf_torch.cli.get_res --conf ./fit_confs/get_res_12.conf --case get_res_12
    python -m honerf_torch.cli.get_res --conf ./fit_confs/get_render_type12.conf --case render_res --render True

Meshes and inner-point ids (or with --render the held-out views' renders)
from the fitted poses under general.fit_res_root.  --render is parsed as
the reference parses it (type=bool: any non-empty value is true).  It
runs on the CUDA device --gpu (default 0); the CPU is reachable only
through the Python API (GetResRunner(..., device="cpu")).
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
    parser.add_argument("--gpu", type=int, default=0)
    parser.add_argument("--case", type=str, default="")
    parser.add_argument("--render", type=bool, default=False)
    args = parser.parse_args(argv)
    if not os.path.exists(args.conf):
        raise SystemExit(f"config file not found: {args.conf}")

    import torch

    from honerf_torch.fit.runner import GetResRunner

    device = torch.device("cuda", args.gpu)
    if torch.cuda.is_available():
        torch.cuda.set_device(device)  # the kernels launch on the current device
    GetResRunner(args.conf, args.case, args.render, device=device).fitting()


if __name__ == "__main__":
    main()
