"""The end-to-end demo CLI (counterpart of the root ``main.py``): a tiny
test training, then inference from its directory.

    python -m minimagen_tpu_torch.main [--DEVICE cpu]

Both steps run as subprocesses of this interpreter from the current
directory, on ``--DEVICE`` (default ``cuda``).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from datetime import datetime
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--DEVICE", dest="DEVICE", default="cuda",
                        help="torch device to train and sample on (default cuda)")
    args = parser.parse_args(argv)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    device = ["--DEVICE", args.DEVICE]
    subprocess.check_call([sys.executable, "-m", "minimagen_tpu_torch.train", "-test",
                           "-ts", timestamp, *device])
    subprocess.check_call([sys.executable, "-m", "minimagen_tpu_torch.inference",
                           "-d", f"training_{timestamp}", *device])


if __name__ == "__main__":
    main()
